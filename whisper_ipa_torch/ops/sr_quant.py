"""Stochastic-rounding int8 weight quantization on the device: the K9
kernel (``csrc/sr_quant.cu``) and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/sr_quant.py``. The host quantizer
(``ops/quant.quantize_params``) copies every weight to the host and back;
``quantize_params_device`` quantizes the weights where they lie, in one
pass over device memory, with the same output layout: {"w_q": int8 (in,
out), "w_s": f32 (out,)}, "w" dropped.

Per output channel, s = max(max|w[:, o]|, 1e-8) / 127 and q = clip(floor(w
/ s + u), -127, 127) with u uniform in [0, 1): rounding is stochastic, so
E[q s] = w. u comes from a counter-based Philox4x32-10 keyed by the seed
and indexed by (row, col), in the kernel and in the plain version alike, so
the two agree bit for bit. The JAX package draws u from the TPU's own bits
or ``jax.random``; those bits are not reproduced, only the contract: codes
are the floor or the ceiling of the IEEE quotient, the error is below one
step, the mean is unbiased, and the scales equal the host quantizer's.

CPU tensors run the plain version; CUDA tensors run the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build
from .precision import div_ieee

_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (the Random123 constants)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for uint32 values held in int64: the
    64-bit product does not fit in int64, so c is split into 16-bit limbs
    (each partial product is below 2^48)."""
    t = m * (c & 0xFFFF)
    u = m * (c >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = (t + ((u & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters (c0..c3), int64 tensors of uint32 values,
    under key (k0, k1); returns the four output words the same way."""
    k0 &= _MASK32
    k1 &= _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_bits(rows: int, cols: int, seed: int, device=None) -> torch.Tensor:
    """(rows, cols) f32 u in [0, 1): word 0 of Philox4x32-10 at counter
    (col, row, 0, 0) and key (seed, 0), its top 23 bits as a mantissa."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    c0, c1 = c.expand(rows, cols), r.expand(rows, cols)
    zero = torch.zeros_like(c0)
    bits = philox4x32_10(c0, c1, zero, zero, seed, 0)[0]
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def stochastic_quantize_int8_plain(w: torch.Tensor, seed: int = 0):
    """Plain PyTorch K9: (in, out) -> (int8 codes (in, out), f32 scales
    (out,)), with the kernel's arithmetic (IEEE divisions, Philox bits)."""
    w = w.to(torch.float32)
    s = div_ieee(torch.clamp_min(w.abs().amax(dim=0), 1e-8), 127.0)
    u = uniform_bits(w.shape[0], w.shape[1], seed, w.device)
    q = torch.clamp(torch.floor(w / s + u), -127, 127).to(torch.int8)
    return q, s


def stochastic_quantize_int8(w: torch.Tensor, seed: int = 0):
    """K9 wrapper: (in, out) float -> (int8 codes (in, out), f32 scales
    (out,)), per-output-channel symmetric, stochastically rounded.

    CUDA tensors run the kernel (the outputs stay on the card); CPU tensors
    run the plain version.
    """
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"want a non-empty (in, out) weight, got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return stochastic_quantize_int8_plain(w, seed)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    wc = w.to(torch.float32).contiguous()
    rows, cols = wc.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=w.device)
    s = torch.empty((cols,), dtype=torch.float32, device=w.device)
    fn = _build.entry(
        "sr_quant", "wipa_sr_quant_int8",
        [_build.P, _build.P, _build.P, _build.I, _build.I, _build.U32,
         _build.I, _build.P],
    )
    rc = fn(wc.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols,
            seed & _MASK32, w.device.index,
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(rc, "wipa_sr_quant_int8")
    stochastic_quantize_int8.launches += 1
    return q, s


stochastic_quantize_int8.launches = 0


def quantize_linear_device(p, seed: int = 0):
    """{"w": ...} -> {"w_q", "w_s"} (stochastic rounding, on p's device)."""
    q, s = stochastic_quantize_int8(p["w"], seed=seed)
    out = {k: v for k, v in p.items() if k != "w"}
    out["w_q"] = q
    out["w_s"] = s
    return out


def quantize_params_device(params, quantize_encoder: bool = True,
                           seed: int = 0):
    """int8 weight quantization of a whole tree where it lies.

    The layout of ``ops/quant.quantize_params(bits=8)``; the block weights
    of the decoder, then of the encoder, each get seed + a running count in
    the reference's visit order, so a weight gets the same seed integer in
    both packages.
    """
    counter = [0]

    def visit(tree):
        if isinstance(tree, dict):
            w = tree.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                counter[0] += 1
                return quantize_linear_device(tree, seed=seed + counter[0])
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v) for v in tree]
        return tree

    out = dict(params)
    for side in ("decoder", "encoder") if quantize_encoder else ("decoder",):
        out[side] = {
            k: (visit(v) if k == "blocks" else v)
            for k, v in params[side].items()
        }
    return out
