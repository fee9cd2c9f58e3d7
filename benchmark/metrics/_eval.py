"""The eval cells' per-layer readers, shared by their metric files: each
file names its layer, unit, the end-to-end metric it moves and, for a
kernel, the device kernels that do the work, and reads with one of these.
A reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.metrics._common import device_s, launches_per_step, mfu_pct, stretch
from benchmark.roofline import flops, kernels, peaks


def decode_step_ms(facts) -> Optional[float]:
    """Host-clock time of one decoder forward in the decode loop: the span
    around ``decode.decoding.decode`` (cache build, the prefix step, the
    single-token steps, the host's text), synchronised, over the forwards
    it ran: the prefix step and ``sample_len`` - 1 single steps."""
    t = facts.get("spans", {}).get("decode")
    if not t or "sample_len" not in facts:
        return None
    return 1e3 * sum(t) / (len(t) * facts["sample_len"])


def encode_ms(facts) -> Optional[float]:
    """Host-clock time of a batch's log-mel and encoder: the span around
    ``ops.log_mel_spectrogram`` and ``models.whisper.encode``,
    synchronised, averaged over the batches outside the profiled
    stretch."""
    t = facts.get("spans", {}).get("encode")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)


def decode_launches(facts) -> Optional[float]:
    """Device operations (kernels, copies, fills) the profiler records
    inside the ``decode`` spans of the profiled stretch, over the decoder
    forwards those spans ran."""
    if "sample_len" not in facts:
        return None
    return launches_per_step(facts, "decode", facts["sample_len"])


def _kernel_ops(facts, span: str, names: Sequence[str]):
    st = stretch(facts)
    if st is None or "batch" not in facts:
        return None, None
    ops = [op for op in st.in_spans(span) if any(k in op[0] for k in names)]
    return st, ops or None


def k2_roofline(facts, names: Sequence[str]) -> Optional[float]:
    """The encoder's self-attention against its roofline: the least time
    the card could take for the (batch x heads, 1500, 64) bfloat16
    attention of every encoder layer of the profiled batches (the larger
    of its operations over the bf16 peak and its bytes over the memory
    rate), over the device time of the kernels ``names``."""
    st, ops = _kernel_ops(facts, "encode", names)
    if ops is None:
        return None
    d = facts["dims"]
    H = d["encoder_heads"]
    n_bytes, n_flops = kernels.encoder_attention(facts["batch"] * H, d["n_audio_ctx"],
                                                 d["d_model"] // H)
    bound = peaks.bound_s(facts["device_name"], n_bytes, n_flops)
    if bound is None:
        return None
    calls = st.count("encode") * d["encoder_layers"]
    return 100.0 * calls * bound / device_s(ops)


def k4_roofline(facts, names: Sequence[str]) -> Optional[float]:
    """The decode steps' cross-attention over the int8 cache against its
    roofline: the least time the card could take to read every
    single-query step's K and V codes and scales over the 1500 audio
    positions of every decoder layer (and q, and write the output), over
    the device time of the kernels ``names``."""
    st, ops = _kernel_ops(facts, "decode", names)
    if ops is None or "sample_len" not in facts:
        return None
    d = facts["dims"]
    H = d["decoder_heads"]
    n_bytes, n_flops = kernels.int8_cross_attention(facts["batch"] * H, d["n_audio_ctx"],
                                                    d["d_model"] // H, q_bytes=2)
    bound = peaks.bound_s(facts["device_name"], n_bytes, n_flops)
    if bound is None:
        return None
    calls = st.count("decode") * d["decoder_layers"] * (facts["sample_len"] - 1)
    return 100.0 * calls * bound / device_s(ops)


def batch_mfu(facts) -> Optional[float]:
    """The whole batch's share of the card's bf16 peak: the model's
    encoder and decoder FLOPs for every row (``roofline.flops``; the
    cached decode over the prefix and ``sample_len`` - 1 further
    positions, no log-mel), over the host-clock time of the batches
    outside the profiled stretch."""
    if "sample_len" not in facts:
        return None
    d = facts["dims"]
    row = flops.encoder_flops(d["n_mels"], d["d_model"], d["encoder_layers"],
                              d["n_audio_ctx"])
    row += flops.decoder_flops(d["d_model"], d["decoder_layers"], d["n_vocab"],
                               facts["n_prefix"] + facts["sample_len"] - 1,
                               d["n_audio_ctx"])
    return mfu_pct(facts, facts["batch"] * row)
