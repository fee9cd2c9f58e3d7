"""Single-query cross-attention over the quantized T-minor cache: K4 (int8)
and K8 (nibble-packed int4), both in ``csrc/decode_attention.cu``, each
beside its plain version.

Counterparts of ``whisper_ipa_tpu/ops/decode_attention.
decode_cross_attention_int8_tminor`` and ``..._int4_tminor``. The JAX
package keeps both kernels off by default because XLA fuses the convert
(and the nibble shifts) into its einsums; eager PyTorch does not, and would
write a copy of the whole cache (two bf16 planes of it for int4) on every
layer of every token, so the port runs the kernels for every single-query
step with a quantized cache on CUDA
(``models/layers.multi_head_attention_int8kv``).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .quant import unpack_nibbles
from .quant_matmul import _sm_count


def decode_attention_plain(q, k_i8, k_scale, v_i8, v_scale):
    """Plain PyTorch K4: the einsum path of ``multi_head_attention_int8kv``.

    q: (B, H, S, Dh) pre-scaled by Dh^-0.5; k_i8/v_i8: (B, H, Dh, T) int8;
    scales: (B, H, T) f32, 0 marking a padded position -> (B, H, S, Dh).
    """
    logits = torch.matmul(q, k_i8.to(q.dtype)).float()
    ks = k_scale[:, :, None, :]
    logits = torch.where(ks > 0.0, logits * ks, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = (w * v_scale[:, :, None, :]).to(q.dtype)
    return torch.matmul(w, v_i8.to(q.dtype).transpose(-1, -2))


def decode_attention_int4_plain(q, k_p4, k_scale, v_p4, v_scale):
    """Plain PyTorch K8: the reference's nibble-plane einsum path
    (``layers._mha_int4kv``), in q's dtype.

    q: (B, H, S, Dh) pre-scaled by Dh^-0.5; k_p4/v_p4: (B, H, Dh, T_pad/2)
    int8, two positions a byte; scales: (B, H, T_pad) f32, 0 marking a
    padded position -> (B, H, S, Dh). Each plane is contracted on its own
    and only the (B, H, S, T) logits and probabilities are interleaved.
    """
    B, H, S, _ = q.shape
    t2 = k_p4.shape[-1]
    k_lo, k_hi = unpack_nibbles(k_p4, q.dtype)
    l_even = torch.matmul(q, k_lo).float()
    l_odd = torch.matmul(q, k_hi).float()
    logits = torch.stack([l_even, l_odd], dim=-1).reshape(B, H, S, 2 * t2)
    ks = k_scale[:, :, None, :]
    logits = torch.where(ks > 0.0, logits * ks, float("-inf"))
    w = torch.softmax(logits, dim=-1) * v_scale[:, :, None, :]
    v_lo, v_hi = unpack_nibbles(v_p4, q.dtype)
    w_even = w[..., 0::2].to(q.dtype)
    w_odd = w[..., 1::2].to(q.dtype)
    return (torch.matmul(w_even, v_lo.transpose(-1, -2))
            + torch.matmul(w_odd, v_hi.transpose(-1, -2)))


K4_MAX_SPLIT = 8     # blocks a thread-block cluster (the portable maximum)
K4_MAX_SLICE = 1024  # positions a block: its codes fill shared memory


@functools.lru_cache(maxsize=None)
def k4_split_plan(t_pad: int):
    """K4's split of T: (splits, slice), a thread-block cluster of
    ``splits`` blocks (at most 8) for each (b, h), each over ``slice``
    positions, so ``splits * slice == t_pad`` and every position is one
    block's. A slice is a multiple of 16 positions (16-byte copies of the
    int8 codes, four of the f32 scales) and aims at 256 positions (6
    slices at T_pad 1536; ``chip_smoke.py`` times 4, 6 and 8); a short
    T_pad is one block's."""
    if t_pad <= 0 or t_pad % 128:
        raise ValueError(f"T_pad={t_pad} must be a positive multiple of 128")
    target = max(1, min(K4_MAX_SPLIT, t_pad // 256))
    splits = max(s for s in range(1, target + 1) if (t_pad // 16) % s == 0)
    slice_t = t_pad // splits
    if slice_t > K4_MAX_SLICE:
        raise ValueError(f"T_pad={t_pad} above K4's {K4_MAX_SPLIT * K4_MAX_SLICE}")
    return splits, slice_t


K8_MAX_SLICE = 2048  # positions a block: its packed codes fill shared memory
K8_SLICE = 768       # positions a block aims at when the grid fills the card
K8_SLICE_FEW = 256   # ... and when it would leave over half the SMs idle


@functools.lru_cache(maxsize=None)
def k8_split_plan(t_pad: int, bh: int, sms: int = 132):
    """K8's split of T for ``bh`` (b, h) rows on ``sms`` SMs: (splits,
    slice), a thread-block cluster of ``splits`` blocks (at most 8) for
    each (b, h), block r over positions [r * slice, min((r + 1) * slice,
    T_pad)), so every position is one block's and no block is empty. A
    slice is a multiple of 32 positions (16-byte copies of the packed
    codes), the last one possibly shorter. It aims at ``K8_SLICE``
    positions, or at ``K8_SLICE_FEW`` where B*H blocks of 768 would fill
    fewer than half the SMs. On the H100 at T_pad 1536 (PERF.md section 6)
    that takes 2 x 768 at B*H 192 and 48 and 6 x 256 at B*H 12, the
    fastest or within 2% of it there."""
    if t_pad <= 0 or t_pad % 128:
        raise ValueError(f"T_pad={t_pad} must be a positive multiple of 128")
    target = K8_SLICE if 2 * bh * -(-t_pad // K8_SLICE) >= sms else K8_SLICE_FEW
    splits = min(K4_MAX_SPLIT, -(-t_pad // target))
    slice_t = -(-t_pad // (32 * splits)) * 32
    if slice_t > K8_MAX_SLICE:
        raise ValueError(f"T_pad={t_pad} above K8's {K4_MAX_SPLIT * K8_MAX_SLICE}")
    return -(-t_pad // slice_t), slice_t


def _check(q, k, k_scale, v, v_scale, t_codes: int, name: str):
    B, H, S, Dh = q.shape
    if S != 1:
        raise ValueError(f"{name} is single-query")
    if k.shape != (B, H, Dh, t_codes) or v.shape != k.shape:
        raise ValueError(
            f"codes must be (B, H, Dh, {t_codes}) int8 matching q "
            f"{tuple(q.shape)}, got {tuple(k.shape)}, {tuple(v.shape)}"
        )
    T = k_scale.shape[-1]
    if k_scale.shape != (B, H, T) or v_scale.shape != (B, H, T):
        raise ValueError("scales must be (B, H, T)")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("codes must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("scales must be float32")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if T % 128 != 0:
        raise ValueError(f"T={T} must be padded to a multiple of 128")


def _check_cuda(q, k, k_scale, v, v_scale):
    tensors = (q, k, k_scale, v, v_scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one CUDA device")
    if q.shape[-1] not in (32, 64):
        raise ValueError(f"head dim {q.shape[-1]} not supported (32 or 64)")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")


def launch_cluster(kind: str, q, k, k_scale, v, v_scale, splits: int,
                   slice_t: int):
    """Launch K4 (``kind`` "int8") or K8 ("int4") once on CUDA tensors, as
    a cluster of ``splits`` blocks of ``slice_t`` positions for each (b, h)
    (the plans above, or another split to time) -> (B, H, 1, Dh); no
    scratch. Raises if the kernel does not build or launch."""
    _check_cuda(q, k, k_scale, v, v_scale)
    B, H, _, Dh = q.shape
    symbol = f"wipa_decode_attention_{kind}"
    out = torch.empty_like(q)
    fn = _build.entry(
        "decode_attention", symbol, [_build.P] * 6 + [_build.I] * 7 + [_build.P]
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), B * H, Dh, k_scale.shape[-1],
        splits, slice_t, int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, symbol)
    return out


def decode_cross_attention_int8_tminor(q, k_i8, k_scale, v_i8, v_scale):
    """K4 wrapper: (B, H, 1, Dh) x int8 (B, H, Dh, T_pad) + scales (B, H,
    T_pad) -> (B, H, 1, Dh) in q's dtype.

    q must carry the full Dh^-0.5 scale; T_pad % 128 == 0 (``init_cache``
    pads). CUDA tensors run the kernel, CPU tensors the plain version.
    """
    _check(q, k_i8, k_scale, v_i8, v_scale, k_scale.shape[-1],
           "decode_cross_attention_int8_tminor")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_i8, k_scale, v_i8, v_scale)
    out = launch_cluster("int8", q, k_i8, k_scale, v_i8, v_scale,
                         *k4_split_plan(k_scale.shape[-1]))
    decode_cross_attention_int8_tminor.launches += 1
    return out


decode_cross_attention_int8_tminor.launches = 0


def decode_cross_attention_int4_tminor(q, k_p4, k_scale, v_p4, v_scale):
    """K8 wrapper: (B, H, 1, Dh) x nibble-packed int4 (B, H, Dh, T_pad/2) +
    scales (B, H, T_pad) -> (B, H, 1, Dh) in q's dtype.

    Byte t2 holds position 2*t2 in its low nibble and 2*t2+1 in its high;
    scale 0 masks a position. q must carry the full Dh^-0.5 scale; T_pad %
    128 == 0. CUDA tensors run the kernel, CPU tensors the plain version.
    """
    _check(q, k_p4, k_scale, v_p4, v_scale, k_scale.shape[-1] // 2,
           "decode_cross_attention_int4_tminor")
    if q.device.type == "cpu":
        return decode_attention_int4_plain(q, k_p4, k_scale, v_p4, v_scale)
    plan = k8_split_plan(k_scale.shape[-1], q.shape[0] * q.shape[1],
                         _sm_count(q.device.index))
    out = launch_cluster("int4", q, k_p4, k_scale, v_p4, v_scale, *plan)
    decode_cross_attention_int4_tminor.launches += 1
    return out


decode_cross_attention_int4_tminor.launches = 0
