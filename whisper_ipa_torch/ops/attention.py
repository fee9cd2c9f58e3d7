"""Unmasked attention forward: the K2 kernel (``csrc/attention.cu``) and its
plain version.

Counterpart of ``whisper_ipa_tpu/ops/attention.fused_attention`` (forward
only). ``models/layers.multi_head_attention`` sends the encoder's
self-attention here under the reference's policy: no mask, bf16 q, at
least 128 queries, on CUDA.

The backward (the TPU kernel's ``_flash_attention_bwd_impl``) is not ported
yet, so the wrapper refuses inputs that require a gradient rather than
returning a result autograd cannot differentiate.
"""

from __future__ import annotations

import torch

from . import _build


def attention_plain(q, k, v, scale: float = 1.0):
    """Plain PyTorch K2, the counterpart of ``_xla_attention``.

    (BH..., Tq, Dh) x (BH..., Tk, Dh) -> (BH..., Tq, Dh); the scale is
    applied to q in its own dtype, logits and softmax are f32, and the
    probabilities are cast back to v's dtype for the value product.
    """
    if scale != 1.0:
        q = q * scale
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def fused_attention(q, k, v, scale: float = 1.0):
    """K2 wrapper: (B, H, Tq, Dh) x (B, H, Tk, Dh) -> (B, H, Tq, Dh), no mask.

    CUDA tensors run the flash-style kernel (bf16 or f32, Dh 32 or 64);
    CPU tensors run ``attention_plain``.
    """
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or (
        q.shape[-1] != k.shape[-1]
    ):
        raise ValueError(
            f"fused_attention wants (B, H, T, Dh) q/k/v, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError(f"fused_attention wants one dtype, f32 or bf16")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"unsupported devices {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "fused_attention has no backward kernel yet (the TPU flash "
            "backward is still to be ported)"
        )
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    if Dh not in (32, 64):
        raise ValueError(f"head dim {Dh} not supported (32 or 64)")
    if Tk < 1:
        raise ValueError("fused_attention needs at least one key")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.entry(
        "attention",
        "wipa_attention_fwd",
        [_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
         _build.I, _build.I, _build.I, _build.F32, _build.I, _build.P],
    )
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Tq, Tk, Dh, int(q.dtype == torch.bfloat16), float(scale),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "wipa_attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
