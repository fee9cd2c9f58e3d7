"""The audio language model cell's readers (``traffic/audio_llm_batch.py``),
shared by their metric files. They read the program's spans
(``_program.stretch_spans``), the launches of the device's operations
(the facts' ``launches``) and the routing counter
(``whisper_ipa_torch.models.audio_llm.routing_records``, in the facts'
``routing``), taking only the counters of the ``decode`` calls whose
spans lie in the profiled stretch. Facts of another ``kind``, or a
program without the counter, leave nothing to read: every reader returns
None. The cell counts a row's tokens as ``new_tokens``: Whisper's readers
take a ``sample_len`` to mean a Whisper decoder's steps."""

from __future__ import annotations

import bisect
import collections
from typing import Optional

from benchmark.metrics._common import launches_per_step, mfu_pct
from benchmark.metrics._program import stretch_spans
from benchmark.roofline import omni, peaks


def _ours(facts) -> bool:
    return facts.get("kind") == "audio_llm_batch"


def _routing(facts):
    """The routing records of the profiled stretch's ``decode`` calls, or
    None."""
    if not _ours(facts):
        return None
    ids = {r.id for r, _, _ in stretch_spans(facts, "decode")}
    got = [x for x in facts.get("routing") or [] if x.call in ids]
    return got or None


def _routed(facts) -> int:
    return facts["llm"]["mlp_dynamic_expert_num"]


def decode_step_ms(facts) -> Optional[float]:
    """Host-clock time of one forward of the language model: the harness's
    span around ``decode.decoding.decode`` (the cache build, the connector
    and the prefill, the single-token steps, the read-back), synchronised,
    over the forwards it ran: the prefill and ``new_tokens`` - 1 steps."""
    t = facts.get("spans", {}).get("decode")
    if not _ours(facts) or not t:
        return None
    return 1e3 * sum(t) / (len(t) * facts["new_tokens"])


def decode_launches(facts) -> Optional[float]:
    """Device operations the profiler records inside the ``decode`` spans
    of the profiled stretch, over the forwards those spans ran."""
    if not _ours(facts):
        return None
    return launches_per_step(facts, "decode", facts["new_tokens"])


def expert_rows_per_token(facts) -> Optional[float]:
    """Expert-GEMM rows computed a token a MoE layer, over the prefill and
    the decode steps: the counter's rows computed over its tokens routed,
    summed over the layers and both phases."""
    recs = _routing(facts)
    if recs is None:
        return None
    rows = tokens = 0
    for rec in recs:
        for phase in (rec.prefill, rec.decode):
            for layer in phase:
                rows += layer[-2]
                tokens += layer[-1]
    return rows / tokens if tokens else None


def moe_roofline(facts) -> Optional[float]:
    """The decode steps' MoE against its bandwidth bound. The program's
    span ``llm.decode.moe`` holds the MoE of one layer of an eager decode
    step (whose kernels every replayed step repeats); the kernels it owns
    are those launched inside the host interval of its markers. For each
    such span, the least time the card could take for what that layer's
    routing needs (``omni.moe_decode_layer``: the routed experts it chose
    in the call's decode steps, the shared experts and the router, read
    once; the picks a step, on average), summed, over the device time of
    the kernels the spans launched."""
    recs = _routing(facts)
    launches = facts.get("launches") or []
    spans = sorted(stretch_spans(facts, "llm.decode.moe"), key=lambda x: x[1])
    if recs is None or not launches or not spans:
        return None
    by_call = {rec.call: rec for rec in recs}
    llm, E = facts["llm"], _routed(facts)
    L = llm["num_hidden_layers"]
    at = [t for t, _, _ in launches]
    seen = collections.Counter()
    bound = busy = 0.0
    for rec, s, e in spans:
        if rec.call not in by_call:
            return None
        layer = by_call[rec.call].decode[seen[rec.call] % L]
        seen[rec.call] += 1
        steps = layer[-1] / facts["batch"]
        if not steps:
            return None
        needed = sum(1 for n in layer[:E] if n)
        n_bytes, n_flops = omni.moe_decode_layer(llm, facts["batch"], needed,
                                                 sum(layer[:E]) / steps)
        b = peaks.bound_s(facts["device_name"], n_bytes, n_flops)
        if b is None:
            return None
        bound += b
        busy += sum(de - ds for _, ds, de in
                    launches[bisect.bisect_left(at, s):bisect.bisect_left(at, e)]) / 1e6
    return 100.0 * bound / busy if busy > 0 else None


def batch_mfu(facts) -> Optional[float]:
    """The whole batch's share of the card's bf16 peak: ``omni.batch_flops``
    with the routed experts the traced calls' routing chose (their
    average), over the host-clock time of the batches outside the
    profiled stretch."""
    recs = _routing(facts)
    if recs is None:
        return None
    E = _routed(facts)
    picks = sum(sum(layer[:E]) for rec in recs for phase in (rec.prefill, rec.decode)
                for layer in phase) / len(recs)
    n = omni.batch_flops(facts["llm"], facts["dims"], facts["batch"], facts["n_prompt"],
                         facts["new_tokens"], picks)
    return mfu_pct(facts, n)
