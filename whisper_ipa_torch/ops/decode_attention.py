"""Single-query cross-attention over the int8 T-minor cache: the K4 kernel
(``csrc/decode_attention.cu``) and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/decode_attention.
decode_cross_attention_int8_tminor``. The JAX package keeps its kernel off by
default because XLA fuses the int8 convert into its einsums; eager PyTorch
does not, and would write a bf16 copy of the whole cache on every layer of
every token, so the port runs the kernel for every single-query step with
an int8 cache on CUDA (``models/layers.multi_head_attention_int8kv``).
"""

from __future__ import annotations

import torch

from . import _build

_MAX_CHUNK = 8 * 1024  # positions per block: 32 KB of f32 logits


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


def _split(bh: int, t_pad: int, device: torch.device):
    """Blocks along T: enough (split, b*h) blocks for two per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_split = max(1, min(t_pad // 128, -(-2 * sms // bh)))
    chunk = -(-t_pad // n_split)
    chunk = -(-chunk // 128) * 128
    while chunk > _MAX_CHUNK:
        chunk = -(-(chunk // 2) // 128) * 128
    return -(-t_pad // chunk), chunk


def decode_cross_attention_int8_tminor(q, k_i8, k_scale, v_i8, v_scale):
    """K4 wrapper: (B, H, 1, Dh) x int8 (B, H, Dh, T_pad) + scales (B, H,
    T_pad) -> (B, H, 1, Dh) in q's dtype.

    q must carry the full Dh^-0.5 scale; T_pad % 128 == 0 (``init_cache``
    pads). CUDA tensors run the kernel, CPU tensors the plain version.
    """
    B, H, S, Dh = q.shape
    if S != 1:
        raise ValueError("decode_cross_attention_int8_tminor is single-query")
    if k_i8.shape != (B, H, Dh, k_i8.shape[-1]) or v_i8.shape != k_i8.shape:
        raise ValueError(
            f"codes must be (B, H, Dh, T) int8 matching q {tuple(q.shape)}, "
            f"got {tuple(k_i8.shape)}, {tuple(v_i8.shape)}"
        )
    T = k_i8.shape[-1]
    if k_scale.shape != (B, H, T) or v_scale.shape != (B, H, T):
        raise ValueError("scales must be (B, H, T)")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise ValueError("codes must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("scales must be float32")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if T % 128 != 0:
        raise ValueError(f"T={T} must be padded to a multiple of 128")
    tensors = (q, k_i8, k_scale, v_i8, v_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(*tensors)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one CUDA device")
    if Dh not in (32, 64):
        raise ValueError(f"head dim {Dh} not supported (32 or 64)")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")

    n_split, chunk = _split(B * H, T, q.device)
    out = torch.empty_like(q)
    part = torch.empty(
        (B * H, n_split, Dh + 2), dtype=torch.float32, device=q.device
    )
    fn = _build.entry(
        "decode_attention",
        "wipa_decode_attention_int8",
        [_build.P] * 7 + [_build.I] * 6 + [_build.I, _build.P],
    )
    rc = fn(
        q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v_i8.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        B * H, Dh, T, n_split, chunk, int(q.dtype == torch.bfloat16),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wipa_decode_attention_int8")
    decode_cross_attention_int8_tminor.launches += 1
    return out


decode_cross_attention_int8_tminor.launches = 0
