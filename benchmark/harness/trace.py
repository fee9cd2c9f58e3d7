"""Spans around the harness's calls into the program, and the profiler's
stretch reduced to what the per-layer metrics read.

A span is a host-clock interval around one call into a layer, with the
device synchronised at both ends, so its time is the call's and its
kernels run inside it. In the profiled stretch each span is also a
``torch.profiler.record_function`` range named ``bench.<span>``, which
places the device's kernels in the span that launched them.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench."


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Host-clock spans by name. ``enabled`` False makes ``span`` a no-op:
    an untraced run synchronises nothing of its own."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, keep: bool = True):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            _sync()
            t0 = time.perf_counter()
            yield
            _sync()
            if keep:
                self.times[name].append(time.perf_counter() - t0)


@dataclass
class Stretch:
    """The profiled stretch: device operations and host ranges, in
    microseconds on the profiler's clock."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window(self) -> Optional[Tuple[float, float]]:
        if not self.spans:
            return None
        return min(s[1] for s in self.spans), max(s[2] for s in self.spans)

    def busy_us(self) -> float:
        """The union of device operations' intervals inside the window."""
        w = self.window
        if w is None:
            return 0.0
        total, cur_end = 0.0, w[0]
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, cur_end), min(e, w[1])
            if e > s:
                total += e - s
                cur_end = e
        return total

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which no device operation ran."""
        w = self.window
        if w is None:
            return []
        out, cur = [], w[0]
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if s > cur:
                out.append((cur, min(s, w[1])))
            cur = max(cur, e)
            if cur >= w[1]:
                break
        if cur < w[1]:
            out.append((cur, w[1]))
        return [g for g in out if g[1] > g[0]]

    def in_spans(self, name: str) -> List[Tuple[str, float, float]]:
        """Device operations that started inside a span of ``name``."""
        ranges = sorted((s, e) for n, s, e in self.spans if n == name)
        out = []
        for op in self.device:
            for s, e in ranges:
                if s <= op[1] <= e:
                    out.append(op)
                    break
        return out

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


def profile(fn) -> Stretch:
    """Run ``fn()`` under ``torch.profiler`` (host and device activity) and
    reduce its events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        _sync()
    st = Stretch()
    for e in prof.events():
        r = e.time_range
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith(PREFIX):
            if not on_device:
                st.spans.append((e.name[len(PREFIX):], r.start, r.end))
        elif on_device:
            st.device.append((e.name, r.start, r.end))
        else:
            st.host.append((e.name, r.start, r.end))
    return st


def breakdown(st: Stretch, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the device's idle
    time summed by what the host was doing when each gap began, both in
    seconds over the stretch."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in st.device:
        by_op[name[:160]] += (e - s) / 1e6
    idle: Dict[str, float] = defaultdict(float)
    host = sorted(st.host, key=lambda x: x[1])
    starts = [x[1] for x in host]
    spans = sorted(st.spans, key=lambda x: x[1])
    for s, e in st.gaps():
        idle[_host_at(spans, host, starts, s)] += (e - s) / 1e6

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(idle)}


def _host_at(spans, host, starts, t: float) -> str:
    """The span and the outermost host operation open at time ``t``, among
    the 64 that started last before it (``host`` sorted by start,
    ``starts`` its start times): the call the host was in."""
    i = bisect.bisect_right(starts, t)
    best = None
    for x in host[max(0, i - 64):i]:
        if x[2] >= t and (best is None or x[2] - x[1] > best[2] - best[1]):
            best = x
    span = None
    for x in spans:
        if x[1] <= t <= x[2]:
            span = x
    where = span[0] if span else "between spans"
    return f"{where}: {best[0]}" if best else where
