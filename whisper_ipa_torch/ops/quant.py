"""Weight-only int8/int4 quantization of the linear weights, on the host.

Counterpart of ``whisper_ipa_tpu/ops/quant.py``, with the same NumPy
arithmetic, so that codes and scales are bit-identical to the JAX package's;
the results are torch tensors on the CPU (the caller moves the tree).

int8: per output channel, s[out] = max|w[:, out]| / 127, q = round(w / s).
int4: per (group of ``group`` input rows, output channel), s = max|w| / 7,
codes in [-8, 7], nibble-packed two to a byte along the input dim (row 2i
in the low nibble, 2i+1 in the high); ``stochastic`` rounds as
floor(w / s + u), u ~ U[0, 1) from ``np.random.default_rng(seed)``.

Biases, layer norms, embeddings and the conv stem stay float.
``models/layers.linear`` consumes {"w_q", "w_s"} and {"w_q4", "w_s4"}.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def quantize_linear(p: Dict[str, Any]) -> Dict[str, Any]:
    """{"w": (in, out), ...} -> {"w_q": int8, "w_s": (out,) f32, ...}."""
    w = _host(p["w"])
    s = np.max(np.abs(w), axis=0) / 127.0
    s = np.where(s == 0.0, 1.0, s).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    out = {k: v for k, v in p.items() if k != "w"}
    out["w_q"] = torch.from_numpy(q)
    out["w_s"] = torch.from_numpy(s)
    return out


def pack_int4(q: np.ndarray) -> np.ndarray:
    """(in, out) int8 codes in [-8, 7] -> (in//2, out) nibble-packed int8."""
    if q.shape[0] % 2:
        raise ValueError("input dim must be even to nibble-pack")
    u = q.astype(np.uint8)
    lo = u[0::2] & 0x0F
    hi = (u[1::2] & 0x0F) << 4
    return (lo | hi).view(np.int8)


def unpack_nibbles(packed: torch.Tensor, dtype):
    """Nibble-packed int8 -> (low, high) sign-extended 4-bit codes in
    ``dtype``: the low nibble holds the even element (row or position 2i),
    the high nibble the odd one (2i + 1)."""
    return ((packed << 4) >> 4).to(dtype), (packed >> 4).to(dtype)


def quantize_linear_int4(
    p: Dict[str, Any],
    group: int = 64,
    stochastic: bool = False,
    seed: int = 0,
) -> Dict[str, Any]:
    """{"w": (in, out), ...} -> {"w_q4": (in/2, out) int8, "w_s4": (in/G,
    out) f32, ...}."""
    w = _host(p["w"])
    n_in, n_out = w.shape
    if n_in % group != 0:
        # the reference's fallback: the largest even divisor of n_in
        group = int(np.gcd(n_in, group))
        group = max(group - (group % 2), 2)
    if group % 2:
        raise ValueError("group must be even (nibble packing)")
    wg = w.reshape(n_in // group, group, n_out)
    s = np.max(np.abs(wg), axis=1) / 7.0  # (n_groups, out)
    s = np.where(s == 0.0, 1.0, s).astype(np.float32)
    q = wg / s[:, None, :]
    if stochastic:
        rng = np.random.default_rng(seed)
        q = np.floor(q + rng.random(q.shape, dtype=np.float32))
    else:
        q = np.round(q)
    q = np.clip(q, -8, 7).astype(np.int8).reshape(n_in, n_out)
    out = {k: v for k, v in p.items() if k != "w"}
    out["w_q4"] = torch.from_numpy(pack_int4(q))
    out["w_s4"] = torch.from_numpy(s)
    return out


def _is_linear(node) -> bool:
    return isinstance(node, dict) and "w" in node and np.ndim(node["w"]) == 2


def quantize_tree(tree, bits: int = 8, group: int = 64,
                  stochastic: bool = False, seed: int = 0):
    """Recursively quantize every 2-D linear weight in a param subtree."""
    if _is_linear(tree):
        if bits == 4:
            return quantize_linear_int4(
                tree, group=group, stochastic=stochastic, seed=seed
            )
        return quantize_linear(tree)
    if isinstance(tree, dict):
        return {
            k: quantize_tree(v, bits, group, stochastic, seed)
            for k, v in tree.items()
        }
    if isinstance(tree, list):
        return [quantize_tree(v, bits, group, stochastic, seed) for v in tree]
    return tree


def quantize_params(params, quantize_encoder: bool = True, bits: int = 8,
                    group: int = 64, stochastic: bool = False,
                    seed: int = 0):
    """Quantize the decoder's (and optionally the encoder's) block linears.

    bits 8 or 4. The embeddings (the tied logits head) and the conv stem
    stay full precision, as in the reference.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = dict(params)
    for side in ("decoder", "encoder") if quantize_encoder else ("decoder",):
        sub = dict(params[side])
        sub["blocks"] = [
            quantize_tree(b, bits, group, stochastic, seed)
            for b in sub["blocks"]
        ]
        out[side] = sub
    return out


def quantized_bytes(params) -> int:
    """Total parameter bytes after quantization (for reporting)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    if params is None:
        return 0
    return params.numel() * params.element_size()
