"""Uni-MoE-2.0-Omni's path from speech to text in plain PyTorch, float32.

The published architecture (HIT-TMG/Uni-MoE-2.0-Omni config.json,
arXiv:2511.12609): the Whisper encoder (two GELU convolutions, sinusoidal
positions, pre-LN blocks, a final LayerNorm), a linear audio connector,
and a Qwen2-style decoder-only language model: RMSNorm (eps
``rms_eps``), rotate-half RoPE (theta ``rope_theta``) over the whole head,
grouped-query attention with biases on q, k and v, and an MLP that is a
dynamic-capacity mixture of experts: shared SwiGLU experts always on,
routed SwiGLU experts and null experts under a float32 softmax router,
each token taking the shortest prefix of its sorted probabilities whose
sum reaches ``top_p``, at most ``top_k``. The untied head gives the
logits.

Departures, each where the configuration leaves a choice open (listed as
assumed in the benchmark's configuration file):

- the connector pools the encoder's 1500 frames to ``n_audio_tokens`` by
  adaptive average pooling before its linear map;
- text and audio positions are one sequence 0..T-1 under 1-D RoPE (mRoPE
  with its three sections at the same id);
- a chosen expert's output is weighted by its probability, not
  renormalised over the chosen ones; the shared experts carry no gate; no
  token is dropped;
- every routed expert is computed for every token and weighted by 0 where
  the token did not choose it (the plainest form of the sum).

Everything is float32, TF32 off (``full_fp32``). The parameter tree is the
program's (``whisper_ipa_torch.models.audio_llm``); bfloat16 weights are
taken at their values, in float32.

``taken`` and ``eps`` (``route``): where the program's bfloat16 router and
this float32 one stand within ``eps`` of a boundary (two probabilities
that decide the set, or the running sum against ``top_p``), the reference
takes the program's choice, and counts each one it took that differs
from its own (``forced``); elsewhere it routes by its own gate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def full_fp32() -> None:
    """No TF32 on the card: float32 products in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f(t):
    return t.float()


# -- the tower ------------------------------------------------------------

def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), _f(p["g"]), _f(p["b"]), eps=1e-5)


def _linear(x, p):
    y = x @ _f(p["w"])
    return y + _f(p["b"]) if p.get("b") is not None else y


def _conv(x, p, stride):
    w = _f(p["w"]).permute(2, 1, 0)  # (out, in, width)
    return F.conv1d(x.transpose(1, 2), w, _f(p["b"]), stride=stride,
                    padding=1).transpose(1, 2)


def _sinusoids(length, channels, device):
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float().to(device)


def _mha(x, p, n_head):
    q, k, v = _linear(x, p["query"]), _linear(x, p["key"]), _linear(x, p["value"])
    B, T, d = q.shape

    def heads(t):
        return t.reshape(B, T, n_head, d // n_head).transpose(1, 2)

    w = torch.softmax(heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(d // n_head), -1)
    return _linear((w @ heads(v)).transpose(1, 2).reshape(B, T, d), p["out"])


def encode(enc: Dict, n_head: int, mel):
    """(B, 3000, n_mels) log-mel -> (B, 1500, d) frames."""
    x = F.gelu(_conv(mel.float(), enc["conv1"], 1))
    x = F.gelu(_conv(x, enc["conv2"], 2))
    x = x + _sinusoids(x.shape[1], x.shape[2], x.device)
    for b in enc["blocks"]:
        x = x + _mha(_ln(x, b["attn_ln"]), b["attn"], n_head)
        x = x + _linear(F.gelu(_linear(_ln(x, b["mlp_ln"]), b["mlp1"])), b["mlp2"])
    return _ln(x, enc["ln_post"])


# -- the language model ---------------------------------------------------

def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(g)


def rope(x, theta):
    """Rotate-half RoPE over (B, H, T, Dh) at positions 0..T-1."""
    T, Dh = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float64) / Dh)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1).to(x.device)
    rot = torch.cat([-x[..., Dh // 2:], x[..., :Dh // 2]], -1)
    return x * torch.cos(ang).float() + rot * torch.sin(ang).float()


def attention(x, p, cfg):
    """Causal grouped-query attention, the K/V heads repeated for their
    query heads."""
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = _linear(x, p["q"]).reshape(B, T, H, Dh).transpose(1, 2)
    k = _linear(x, p["k"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = _linear(x, p["v"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = q @ k.transpose(-1, -2) / math.sqrt(Dh)
    s = s + torch.full((T, T), float("-inf"), device=x.device).triu(1)
    out = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, T, H * Dh)
    return _linear(out, p["o"])


def swiglu(x, w1, w2):
    """W_down(silu(W_gate x) * W_up x), ``w1`` = [W_gate | W_up]."""
    f = w1.shape[-1] // 2
    return (F.silu(x @ _f(w1[:, :f])) * (x @ _f(w1[:, f:]))) @ _f(w2)


def route(n, router, cfg, taken: Optional[torch.Tensor] = None, eps: float = 0.0):
    """(weights (N, n_slots): p where chosen, else 0; forced count; slots
    (N, top_k), ``n_slots`` where fewer were taken).

    Own choice: sorted descending (the lower slot first on a tie), entry j
    taken while the sum of the entries before it is under ``top_p``, at
    most ``top_k``. With ``taken`` (the program's slots, (N, top_k)), a
    token whose margin is under ``eps`` takes the program's set: the
    margin is the least of |sum before entry j - top_p| (j = 1 ..
    top_k - 1) and the gap between the last entry taken and the next."""
    p = torch.softmax(n @ _f(router), -1)
    N, S = p.shape
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    before = torch.cat([torch.zeros_like(vals[:, :1]), torch.cumsum(vals, -1)[:, :-1]], -1)
    keep = before[:, :k] < cfg.top_p
    slots = torch.where(keep, idx[:, :k], torch.full_like(idx[:, :k], S))
    forced = 0
    if taken is not None:
        taken = taken.to(slots.device).long()
        n_own = keep.sum(-1)
        margin = (before[:, 1:k] - cfg.top_p).abs().amin(-1)
        last = vals.gather(1, (n_own - 1)[:, None])[:, 0]
        nxt = vals.gather(1, n_own.clamp(max=S - 1)[:, None])[:, 0]
        margin = torch.minimum(margin, last - nxt)
        differ = (slots.sort(-1).values != taken.sort(-1).values).any(-1)
        use = differ & (margin < eps)
        forced = int(use.sum())
        slots = torch.where(use[:, None], taken, slots)
    weights = torch.zeros((N, S + 1), device=p.device)
    pp = torch.cat([p, torch.zeros_like(p[:, :1])], -1)
    weights.scatter_(1, slots, pp.gather(1, slots))
    return weights[:, :S], forced, slots


def moe(n, p, cfg, taken=None, eps=0.0):
    """(output, forced, slots): the shared experts plus every routed
    expert weighted by the token's probability where it chose it."""
    w, forced, slots = route(n, p["router"], cfg, taken, eps)
    y = torch.zeros_like(n)
    for s in range(cfg.n_shared):
        y = y + swiglu(n, p["shared_w1"][s], p["shared_w2"][s])
    for e in range(cfg.n_routed):
        y = y + w[:, e:e + 1] * swiglu(n, p["experts_w1"][e], p["experts_w2"][e])
    return y, forced, slots


def forward(params: Dict, cfg, mel, prompt_ids, audio_start: int, tokens,
            taken: Optional[torch.Tensor] = None, eps: float = 0.0):
    """Teacher-forced logits over [prompt; tokens]: (logits (B, T, V)
    float32, forced, slots (L, B, T, top_k)). ``prompt_ids`` (B, P) holds
    ``n_audio_tokens`` audio slots from ``audio_start``; ``taken`` (L, B,
    T, top_k), the program's routes, for the near-tie rule."""
    full_fp32()
    frames = encode(params["tower"]["encoder"], cfg.tower.n_audio_head, mel)
    pooled = F.adaptive_avg_pool1d(frames.transpose(1, 2), cfg.n_audio_tokens)
    audio = _linear(pooled.transpose(1, 2), params["connector"])
    emb = _f(params["embed"])
    end = audio_start + cfg.n_audio_tokens
    x = torch.cat([emb[prompt_ids[:, :audio_start]], audio, emb[prompt_ids[:, end:]],
                   emb[tokens]], 1)
    B, T, D = x.shape
    forced, routes = 0, []
    for l, p in enumerate(params["layers"]):
        x = x + attention(rms_norm(x, p["attn_norm"], cfg.rms_eps), p, cfg)
        n = rms_norm(x, p["mlp_norm"], cfg.rms_eps).reshape(B * T, D)
        t = taken[l].reshape(B * T, -1) if taken is not None else None
        y, f, slots = moe(n, p, cfg, t, eps)
        forced += f
        routes.append(slots.reshape(B, T, -1))
        x = x + y.reshape(B, T, D)
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    return x @ _f(params["head"]), forced, torch.stack(routes)


__all__: List[str] = ["encode", "forward", "moe", "route", "rope", "attention"]
