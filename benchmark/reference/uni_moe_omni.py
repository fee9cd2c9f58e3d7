"""Uni-MoE-2.0-Omni's path from speech to text in plain PyTorch: the
Whisper-large encoder (``whisper.encode_blocks``), a linear audio
connector, and a Qwen2-style decoder-only language model whose MLP is a
dynamic-capacity mixture of experts (HIT-TMG/Uni-MoE-2.0-Omni
config.json, arXiv:2511.12609), teacher-forced.

The layer: h = x + Attn(RMSNorm(x)), x' = h + MoE(RMSNorm(h)). Attn:
biases on q, k and v, none on o; rotate-half RoPE (theta 1e6) over the
whole 128-wide head; 28 query heads over 4 K/V heads, each K/V head
repeated for its 7 query heads; causal softmax(q k^T / sqrt(128)) v.
MoE: p = softmax(W_g n) over 4 routed experts and 1 null expert; sorted
in descending order (lower slot first on a tie), entry j taken while the
sum of the entries before it is under 0.7, at most 2; y = the 2 shared
SwiGLU experts + sum of p_i E_i(n) over the chosen routed ones, every
routed expert computed for every token and weighted by 0 where it was not
chosen. A final RMSNorm (eps 1e-6) and the untied head.

Departures, where the configuration leaves a choice (its ``assumed``):
adaptive average pooling of the 1500 frames to 200 before the
connector's linear map; one sequence of positions for text and audio
(1-D RoPE); weights p, not renormalised; ungated shared experts.

Every product goes through ``precision.mm``, so the same code runs the
float32 reference and its float8 control. Weights come part by part from
``get(name)`` (``tower``, ``connector``, ``embed``, ``layers.<l>``,
``norm``, ``head``), in float32, so that one layer is held at a time.

The near-tie rule (``route``): where the program's choice for a token
(``taken``) differs from this reference's own and the reference's margin
is under ``eps`` (the least of |sum before entry j - 0.7| for the entries
that could be taken after the first, and the gap between the last entry
taken and the next), the reference takes the program's choice and counts
it (``forced``); everywhere else it routes by its own gate.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import whisper
from .precision import FP32, Precision


def rms_norm(x, g, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def linear(x, p, prec: Precision):
    y = prec.mm(x, p["w"])
    return y + p["b"] if p.get("b") is not None else y


def rope(x, theta: float):
    """Rotate-half RoPE over (B, H, T, Dh) at positions 0..T-1."""
    T, Dh = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float64) / Dh)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1).to(x.device)
    rot = torch.cat([-x[..., Dh // 2:], x[..., :Dh // 2]], -1)
    return x * torch.cos(ang).float() + rot * torch.sin(ang).float()


def attention(x, p, c, prec: Precision):
    B, T, _ = x.shape
    H, Hkv, Dh = c.n_head, c.n_kv_head, c.head_dim
    q = linear(x, p["q"], prec).reshape(B, T, H, Dh).transpose(1, 2)
    k = linear(x, p["k"], prec).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = linear(x, p["v"], prec).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q, k = rope(q, c.rope_theta), rope(k, c.rope_theta)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
    s = s + torch.full((T, T), float("-inf"), device=x.device).triu(1)
    out = prec.mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, T, H * Dh)
    return linear(out, p["o"], prec)


def swiglu(x, w1, w2, prec: Precision):
    """W_down(silu(W_gate x) * W_up x), ``w1`` = [W_gate | W_up]."""
    f = w1.shape[-1] // 2
    return prec.mm(F.silu(prec.mm(x, w1[:, :f])) * prec.mm(x, w1[:, f:]), w2)


def route(n, router, c, prec: Precision, taken: Optional[torch.Tensor] = None,
          eps: float = 0.0):
    """(weights (N, slots): p where chosen, else 0; forced; slots (N,
    top_k), ``slots`` where fewer were taken)."""
    p = torch.softmax(prec.mm(n, router), -1)
    N, S = p.shape
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    k = c.top_k
    before = torch.cat([torch.zeros_like(vals[:, :1]), torch.cumsum(vals, -1)[:, :-1]], -1)
    keep = before[:, :k] < c.top_p
    slots = torch.where(keep, idx[:, :k], torch.full_like(idx[:, :k], S))
    forced = 0
    if taken is not None:
        taken = taken.to(slots.device).long()
        n_own = keep.sum(-1)
        margin = (before[:, 1:k] - c.top_p).abs().amin(-1)
        last = vals.gather(1, (n_own - 1)[:, None])[:, 0]
        nxt = vals.gather(1, n_own.clamp(max=S - 1)[:, None])[:, 0]
        margin = torch.minimum(margin, last - nxt)
        differ = (slots.sort(-1).values != taken.sort(-1).values).any(-1)
        use = differ & (margin < eps)
        forced = int(use.sum())
        slots = torch.where(use[:, None], taken, slots)
    pp = torch.cat([p, torch.zeros_like(p[:, :1])], -1)
    weights = torch.zeros((N, S + 1), device=p.device)
    weights.scatter_(1, slots, pp.gather(1, slots))
    return weights[:, :S], forced, slots


def moe(n, p, c, prec: Precision, taken=None, eps: float = 0.0):
    w, forced, slots = route(n, p["router"], c, prec, taken, eps)
    y = torch.zeros_like(n)
    for s in range(c.n_shared):
        y = y + swiglu(n, p["shared_w1"][s], p["shared_w2"][s], prec)
    for e in range(c.n_routed):
        y = y + w[:, e:e + 1] * swiglu(n, p["experts_w1"][e], p["experts_w2"][e], prec)
    return y, forced, slots


def logits(get: Callable, c, mel, prompt_ids, audio_start: int, tokens,
           prec: Precision = FP32, taken: Optional[torch.Tensor] = None,
           eps: float = 0.0, keep_from: int = 0):
    """Teacher-forced over [prompt; tokens]: (logits (B, T - keep_from, V)
    float32 of positions keep_from.., forced, slots (L, B, T, top_k)).
    ``prompt_ids`` (B, P) holds the ``n_audio_tokens`` audio slots from
    ``audio_start``; ``taken`` (L, B, T, top_k) the program's routes."""
    whisper.full_fp32()
    with torch.no_grad():
        frames = whisper.encode_blocks(get("tower"), c.tower_heads, mel, prec=prec)
        pooled = F.adaptive_avg_pool1d(frames.transpose(1, 2), c.n_audio_tokens)
        audio = linear(pooled.transpose(1, 2), get("connector"), prec)
        del frames, pooled
        emb = get("embed")
        end = audio_start + c.n_audio_tokens
        x = torch.cat([emb[prompt_ids[:, :audio_start]], audio, emb[prompt_ids[:, end:]],
                       emb[tokens]], 1)
        del emb
        B, T, D = x.shape
        forced, routes = 0, []
        for l in range(c.n_layer):
            p = get(f"layers.{l}")
            x = x + attention(rms_norm(x, p["attn_norm"], c.rms_eps), p, c, prec)
            n = rms_norm(x, p["mlp_norm"], c.rms_eps).reshape(B * T, D)
            t = taken[l].reshape(B * T, -1) if taken is not None else None
            y, f, slots = moe(n, p, c, prec, t, eps)
            forced += f
            routes.append(slots.reshape(B, T, -1))
            x = x + y.reshape(B, T, D)
            del p, n, y
        x = rms_norm(x[:, keep_from:], get("norm"), c.rms_eps)
        return prec.mm(x, get("head")).float(), forced, torch.stack(routes)
