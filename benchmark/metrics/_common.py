"""What the per-layer readers share: the profiled stretch's device time
and a configuration's sizes. A reader that finds nothing returns None."""

from __future__ import annotations

from typing import Optional

from benchmark.roofline import peaks


def stretch(facts):
    st = facts.get("stretch")
    return st if st is not None and st.window is not None else None


def device_s(ops) -> float:
    return sum(e - s for _, s, e in ops) / 1e6


def idle_pct(facts) -> Optional[float]:
    st = stretch(facts)
    if st is None:
        return None
    w0, w1 = st.window
    return 100.0 * (1.0 - st.busy_us() / (w1 - w0))


def launches_per_step(facts, span: str, steps_per_span: int) -> Optional[float]:
    st = stretch(facts)
    if st is None or not st.count(span):
        return None
    return len(st.in_spans(span)) / (st.count(span) * steps_per_span)


def mfu_pct(facts, flops_per_unit: float) -> Optional[float]:
    walls = facts.get("walls")
    peak = peaks.peak(facts.get("device_name", ""), "bf16_flops")
    if not walls or peak is None:
        return None
    return 100.0 * flops_per_unit * len(walls) / sum(walls) / peak
