"""Functional building blocks for the Whisper transformer, in PyTorch.

Counterpart of ``whisper_ipa_tpu/models/layers.py``: plain functions over
tensors and parameter dicts, with the reference's layouts kept at every
public function so that the two packages compare like with like:

  linear:  {"w": (in, out), "b": (out,)}        (k-projection has no bias)
  ln:      {"g": (d,), "b": (d,)}
  conv1d:  {"w": (width, in, out), "b": (out,)}  -- 'WIO', NWC activations

Rounding follows the reference: ``linear`` rounds the product to the
activation dtype before adding the bias in that dtype, ``layer_norm``
takes its statistics in f32 and casts back, and softmax is f32. The
1/sqrt(d_head) scale is split as d_head**-0.25 on q and k, except where a
kernel takes it whole on q. Only float weights are handled here; the
reference's quantized-weight branches (``w_q``, ``w_q4``) are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention
from ..ops.decode_attention import (
    decode_attention_plain,
    decode_cross_attention_int8_tminor,
)
from ..ops.precision import full_fp32

# Minimum query length for the fused encoder-attention kernel, as in the
# reference (``_FUSED_MIN_QLEN``): decode steps and short cross-attention
# stay on the plain path.
FUSED_MIN_QLEN = 128


def layer_norm(x, p, eps: float = 1e-5):
    """LayerNorm with f32 statistics regardless of activation dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def linear(x, p):
    """x @ w rounded to x's dtype, then + b in that dtype."""
    y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return y


def conv1d(x, p, stride: int = 1):
    """1-D convolution, padding 1, NWC activations and WIO weights.

    x: (B, W, C_in); p["w"]: (width, C_in, C_out). Runs at full fp32 for
    f32 inputs (cuDNN would otherwise use TF32).
    """
    w = p["w"].to(x.dtype).permute(2, 1, 0)  # (C_out, C_in, width)
    with full_fp32():
        y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=1)
    return y.transpose(1, 2) + p["b"].to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="none")


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embeddings for the audio encoder (the
    reference's NumPy math, unchanged)."""
    if channels % 2:
        raise ValueError("channels must be even")
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(
        -log_timescale_increment * np.arange(channels // 2)
    )
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


def split_heads(x, n_head: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def causal_mask(n_ctx: int, device=None) -> torch.Tensor:
    """(n_ctx, n_ctx) additive causal mask (upper triangle = -inf)."""
    return torch.full((n_ctx, n_ctx), float("-inf"), device=device).triu(1)


def _fused_eligible(q, mask) -> bool:
    """The reference's auto policy: the kernel for unmasked bf16 attention
    with at least FUSED_MIN_QLEN queries, on the accelerator."""
    return (
        mask is None
        and q.dtype == torch.bfloat16
        and q.shape[1] >= FUSED_MIN_QLEN
        and q.device.type == "cuda"
    )


def multi_head_attention(q, k, v, n_head: int, mask=None):
    """Scaled dot-product attention over merged-head projections.

    q/k/v: (B, Tq/Tk, d). mask: additive, broadcastable to (B, H, Tq, Tk).
    """
    d_head = q.shape[-1] // n_head
    if _fused_eligible(q, mask):
        return merge_heads(
            fused_attention(
                split_heads(q, n_head),
                split_heads(k, n_head),
                split_heads(v, n_head),
                scale=float(d_head ** -0.5),
            )
        )
    return _attention_core(q, k, v, mask, n_head=n_head, scale=d_head ** -0.25)


def _attention_core(q, k, v, mask, *, n_head: int, scale: float):
    qh = split_heads(q, n_head) * scale
    kh = split_heads(k, n_head) * scale
    vh = split_heads(v, n_head)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(vh.dtype)
    return merge_heads(torch.matmul(w, vh))


def multi_head_attention_two_part(
    q, k_cache, v_cache, k_new, v_new, n_head: int, mask_cache, mask_new
):
    """Attention over [frozen cache | new in-step keys] without
    concatenating K/V: only the (B, H, S, n_ctx + S) logits are joined.

    mask_cache: additive, broadcastable to (B, H, S, n_ctx);
    mask_new: additive, broadcastable to (B, H, S, S).
    """
    d_head = q.shape[-1] // n_head
    scale = d_head ** -0.25
    qh = split_heads(q, n_head) * scale
    kc = split_heads(k_cache, n_head) * scale
    kn = split_heads(k_new, n_head) * scale
    lc = torch.matmul(qh, kc.transpose(-1, -2)).float() + mask_cache
    ln = torch.matmul(qh, kn.transpose(-1, -2)).float() + mask_new
    n_ctx = lc.shape[-1]
    w = torch.softmax(torch.cat([lc, ln], dim=-1), dim=-1).to(v_cache.dtype)
    out = torch.matmul(w[..., :n_ctx], split_heads(v_cache, n_head)) + (
        torch.matmul(w[..., n_ctx:], split_heads(v_new, n_head))
    )
    return merge_heads(out)


def multi_head_attention_int8kv(q, k_i8, k_scale, v_i8, v_scale, n_head: int):
    """Unmasked attention over the int8 T-minor cache.

    q: (B, S, d); k_i8/v_i8: (B, H, Dh, T_pad) int8; scales: (B, H, T_pad)
    f32 with 0 on padded positions. Single-query steps go to K4 (on CUDA
    the kernel, on CPU its plain version); longer query blocks (the SOT
    prefix) take the plain version directly.
    """
    d_head = q.shape[-1] // n_head
    qh = split_heads(q * (d_head ** -0.5), n_head)  # (B, H, S, Dh)
    if qh.shape[2] == 1:
        out = decode_cross_attention_int8_tminor(
            qh.contiguous(), k_i8, k_scale, v_i8, v_scale
        )
    else:
        out = decode_attention_plain(qh, k_i8, k_scale, v_i8, v_scale)
    return merge_heads(out)


def attention_block(x, p, n_head: int, mask=None, kv=None):
    """Self- or cross-attention through a Whisper attention param group;
    kv, when given, is the pair of already-projected (k, v)."""
    q = linear(x, p["query"])
    if kv is None:
        k = linear(x, p["key"])
        v = linear(x, p["value"])
    else:
        k, v = kv
    out = multi_head_attention(q, k, v, n_head, mask)
    return linear(out, p["out"]), (k, v)


def mlp_block(x, p):
    return linear(gelu(linear(x, p["mlp1"])), p["mlp2"])
