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
kernel takes it whole on q.

``linear`` also takes the quantized forms of ``ops/quant.py``:
{"w_q", "w_s"} (int8, per output channel) and {"w_q4", "w_s4"} (nibble-
packed int4, group scales). On the CPU they take the reference's CPU
routes (weight-only dequantize; the int4 half-weights), so tokens match
the JAX package. On CUDA a decode-shaped int4 call runs K7, and under
``use_int8_activations(True)`` every int8 call runs K6.

``use_int4_matmul`` and ``use_decode_kernel`` are the reference's
switches for K7 and for K4/K8: True (the default) takes the kernel where a
call is eligible on CUDA, False sends those calls down the plain path on
the card too (the kernels' A/B CLIs set it). A switch chooses before
launch; it is not a fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention, fused_attention_merged
from ..ops.decode_attention import (
    decode_attention_int4_plain,
    decode_attention_plain,
    decode_cross_attention_int4_tminor,
    decode_cross_attention_int8_tminor,
)
from ..ops.precision import full_fp32
from ..ops.quant_matmul import int4_halves, int4_matmul, int8_matmul
from ..parallel.sharded import copy_to_tp, reduce_from_tp

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


_INT8_ACTIVATIONS = False


def use_int8_activations(enabled: bool) -> None:
    """Full int8 serving: int8-quantized weights AND activations run K6
    (``ops/quant_matmul.int8_matmul``) on CUDA. It changes the numbers (two
    int8 quantizations), so it is opt-in; the CPU ignores it, as the
    reference does."""
    global _INT8_ACTIVATIONS
    _INT8_ACTIVATIONS = enabled


def _unpack_int4(packed, w_s4, dtype):
    """The full dequantized (in, out) weight, for tests and inspection."""
    lo, hi = int4_halves(packed, w_s4, dtype)
    n_half, n_out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * n_half, n_out)


# K7 serves decode-shaped int4 calls only: the reference's eligibility rule
# (``layers.py:94-101``, whole 8-row tiles of packed rows per scale group
# and M * K <= 2 * 1024 * 1024). Encoder-shaped calls and the cross K/V
# projections of ``init_cache`` (M = B * 1500) take the half-weight path, as
# in the reference. Decided before launch; not a recovery path.
_INT4_MATMUL_MAX_MK = 2 * 1024 * 1024
_INT4_MATMUL = True


def use_int4_matmul(enabled: bool = True) -> None:
    """True (the default) = K7 where eligible, False = never (the
    half-weight path on the card too)."""
    global _INT4_MATMUL
    _INT4_MATMUL = enabled


def _int4_matmul_eligible(x, p) -> bool:
    rows_per_group = p["w_q4"].shape[0] // p["w_s4"].shape[0]
    return (
        _INT4_MATMUL
        and x.device.type == "cuda"
        and rows_per_group % 8 == 0
        and x.numel() <= _INT4_MATMUL_MAX_MK
    )


def linear(x, p):
    """x @ w rounded to x's dtype, then + b in that dtype (the quantized
    forms as in the module docstring)."""
    if "w_q4" in p:
        if _int4_matmul_eligible(x, p):
            y = int4_matmul(x, p["w_q4"], p["w_s4"]).to(x.dtype)
        else:
            lo, hi = int4_halves(p["w_q4"], p["w_s4"], x.dtype)
            # even input features meet the low-nibble half, odd the high
            y = x[..., 0::2] @ lo + x[..., 1::2] @ hi
    elif "w_q" in p:
        if _INT8_ACTIVATIONS and x.device.type == "cuda":
            y = int8_matmul(x, p["w_q"], p["w_s"]).to(x.dtype)
        else:
            # weight-only int8: eager PyTorch writes this dequantized copy
            # on every call (XLA fused it into the product)
            y = x @ (p["w_q"].to(x.dtype) * p["w_s"].to(x.dtype))
    else:
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


# The reference's switches for the encoder's self-attention kernels:
# use_fused_attention(True | False | None): None (auto) takes the kernel for
# bf16 only; use_merged_attention(True) sends eligible calls to K10, the
# head-merged kernel, instead of K2 on split heads (the default, as in the
# reference). WHISPER_IPA_TPU_MERGED_ATTN=1 turns the latter on at import.
_FUSED_ATTENTION = None
_MERGED_ATTENTION = os.environ.get("WHISPER_IPA_TPU_MERGED_ATTN") == "1"


def use_fused_attention(enabled) -> None:
    """True = always (when eligible), False = never, None = auto (bf16)."""
    global _FUSED_ATTENTION
    _FUSED_ATTENTION = enabled


def use_merged_attention(enabled: bool) -> None:
    """Eligible encoder attention through K10 (head-merged I/O)."""
    global _MERGED_ATTENTION
    _MERGED_ATTENTION = enabled


def _fused_eligible(q, mask) -> bool:
    """The reference's policy: the kernel for unmasked attention with at
    least FUSED_MIN_QLEN queries, on the accelerator, for bf16 unless
    ``use_fused_attention`` says otherwise."""
    if mask is not None or q.shape[1] < FUSED_MIN_QLEN:
        return False
    enabled = _FUSED_ATTENTION
    if enabled is None:
        enabled = q.dtype == torch.bfloat16
    return bool(enabled) and q.device.type == "cuda"


def multi_head_attention(q, k, v, n_head: int, mask=None):
    """Scaled dot-product attention over merged-head projections.

    q/k/v: (B, Tq/Tk, d). mask: additive, broadcastable to (B, H, Tq, Tk).
    """
    d_head = q.shape[-1] // n_head
    if _fused_eligible(q, mask):
        if _MERGED_ATTENTION:
            return fused_attention_merged(q, k, v, n_head,
                                          scale=float(d_head ** -0.5))
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


def multi_head_attention_beam_cache(
    q, k_cache, v_cache, k_new, v_new, n_head: int, sel_mask
):
    """Beam self-attention over the unreordered per-row self cache.

    Physical row k keeps the K/V its beam slot wrote; an ancestry table
    says which row holds beam j's history at each position, and the
    additive select-mask (0 where that row and position are beam j's and
    live, -inf elsewhere) picks one row a position inside the softmax, so
    the cache is never copied to follow the beams.

    q/k_new/v_new: (B, J, d), one query and one new K/V a beam;
    k_cache/v_cache: (B, K, n_ctx, d) physical rows (K == J); sel_mask:
    additive (B, J, K, n_ctx). The new token attends itself with no mask.
    """
    B, J, d = q.shape
    K, n_ctx = k_cache.shape[1], k_cache.shape[2]
    d_head = d // n_head
    scale = d_head ** -0.25
    qh = q.reshape(B, J, n_head, d_head) * scale
    kc = k_cache.reshape(B, K, n_ctx, n_head, d_head) * scale
    kn = k_new.reshape(B, J, n_head, d_head) * scale

    lc = torch.einsum("bjhd,bkphd->bhjkp", qh, kc).float()
    lc = lc + sel_mask[:, None]  # (B, H, J, K, n_ctx)
    ln = torch.einsum("bjhd,bjhd->bhj", qh, kn).float()
    flat = torch.cat([lc.reshape(B, n_head, J, K * n_ctx), ln[..., None]], -1)
    w = torch.softmax(flat, dim=-1).to(v_cache.dtype)
    wc = w[..., :-1].reshape(B, n_head, J, K, n_ctx)
    vc = v_cache.reshape(B, K, n_ctx, n_head, d_head)
    out = torch.einsum("bhjkp,bkphd->bjhd", wc, vc)
    out = out + w[..., -1].transpose(1, 2)[..., None] * v_new.reshape(
        B, J, n_head, d_head)
    return out.reshape(B, J, d)


_DECODE_KERNEL = True


def use_decode_kernel(enabled: bool = True) -> None:
    """True (the default) = K4/K8 for single-query steps, False = never
    (the plain path on the card too)."""
    global _DECODE_KERNEL
    _DECODE_KERNEL = enabled


def multi_head_attention_int8kv(q, k_i8, k_scale, v_i8, v_scale, n_head: int):
    """Unmasked attention over the quantized T-minor cross cache.

    q: (B, S, d); k_i8/v_i8: (B, H, Dh, T_pad) int8, or (B, H, Dh, T_pad/2)
    nibble-packed int4 (two positions a byte) when the scales are twice as
    long; scales: (B, H, T_pad) f32 with 0 on padded positions.
    Single-query steps go to K4 (int8) or K8 (int4), the kernel on CUDA and
    its plain version on the CPU, unless ``use_decode_kernel(False)``;
    longer query blocks (the SOT prefix) take the plain version directly.
    """
    d_head = q.shape[-1] // n_head
    qh = split_heads(q * (d_head ** -0.5), n_head)  # (B, H, S, Dh)
    if k_scale.shape[-1] != k_i8.shape[-1]:
        kernel, plain = decode_cross_attention_int4_tminor, decode_attention_int4_plain
    else:
        kernel, plain = decode_cross_attention_int8_tminor, decode_attention_plain
    if qh.shape[2] == 1 and _DECODE_KERNEL:
        out = kernel(qh.contiguous(), k_i8, k_scale, v_i8, v_scale)
    else:
        out = plain(qh, k_i8, k_scale, v_i8, v_scale)
    return merge_heads(out)


def row_linear(x, p, tp=None):
    """A row-parallel product (attention ``out``, ``mlp2``). With ``tp``
    (a ``parallel.sharded.TensorParallel``) ``x`` and ``p["w"]`` are the
    rank's columns and rows: the partial products meet in one all-reduce
    over 'model', and the replicated bias is added once, after it."""
    if tp is None:
        return linear(x, p)
    y = reduce_from_tp(linear(x, {"w": p["w"]}), tp)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return y


def attention_block(x, p, n_head: int, mask=None, kv=None, tp=None):
    """Self- or cross-attention through a Whisper attention param group;
    kv, when given, is the pair of already-projected (k, v). With ``tp``
    the projections are the rank's column blocks and ``n_head`` its local
    head count (Megatron: ``copy_to_tp`` in, ``row_linear`` out)."""
    x = copy_to_tp(x, tp)
    q = linear(x, p["query"])
    if kv is None:
        k = linear(x, p["key"])
        v = linear(x, p["value"])
    else:
        k, v = kv
    out = multi_head_attention(q, k, v, n_head, mask)
    return row_linear(out, p["out"], tp), (k, v)


def mlp_block(x, p, tp=None):
    h = gelu(linear(copy_to_tp(x, tp), p["mlp1"]))
    return row_linear(h, p["mlp2"], tp)


# -- the audio language model's blocks (``models.audio_llm``) -------------

def rms_norm(x, g, eps: float):
    """RMSNorm with f32 statistics: x / sqrt(mean(x^2) + eps) * g, cast
    back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def rope_tables(n_pos: int, head_dim: int, theta: float, device=None):
    """(cos, sin), each (n_pos, head_dim) f32, for rotate-half RoPE over
    the whole head: angle(t, i) = t * theta ** (-2 (i mod head_dim/2) /
    head_dim)."""
    inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64,
                                  device=device) / head_dim)
    ang = torch.arange(n_pos, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x, cos, sin):
    """Rotate-half RoPE in f32 over (..., T, head_dim), with (T, head_dim)
    tables (or tables broadcastable to x), cast back to x's dtype."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def gqa_attention(q, k, v, mask=None):
    """Grouped-query attention: q (B, H, Tq, Dh) over k, v (B, H_kv, Tk,
    Dh), each K/V head serving H / H_kv consecutive query heads, scores
    q k^T / sqrt(Dh) and softmax in f32; mask additive, broadcastable to
    (B, H_kv, H / H_kv, Tq, Tk). Returns (B, H, Tq, Dh). A K/V head's query
    heads are stacked as rows of one product, so K and V are read as they
    are, never repeated."""
    B, H, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G * Tq, Dh) * (Dh ** -0.5)
    s = torch.matmul(qg, k.transpose(-1, -2)).float().view(B, Hkv, G, Tq, Tk)
    if mask is not None:
        s = s + mask
    w = torch.softmax(s, dim=-1).to(v.dtype).view(B, Hkv, G * Tq, Tk)
    return torch.matmul(w, v).view(B, H, Tq, Dh)
