"""An audio language model's path from speech to text: a Whisper encoder,
a linear connector, and a Qwen2-style decoder-only language model whose
MLP is a dynamic-capacity mixture of experts (Uni-MoE-2.0-Omni,
``config.AudioLLMConfig``).

The equations (the configuration's own keys, and what its file lists as
assumed):

- tower: ``models.whisper.encode`` over the log-mel, E (B, 1500, d_audio);
- connector: A = Linear(adaptive_avg_pool1d(E, n_audio_tokens)), with a
  bias, pooled in float32;
- input: X0 = [Emb(pre ids); A; Emb(post ids)], positions 0..T-1 for text
  and audio alike (1-D RoPE: mRoPE with its three sections at one id);
- layer: h = x + Attn(RMSNorm(x)), x' = h + MoE(RMSNorm(h)); Attn has
  biases on q, k and v, none on o, rotate-half RoPE over the whole head
  and grouped-query causal softmax(q k^T / sqrt(Dh)) v;
- MoE: p = softmax(W_g n) in float32 over the routed experts and then the
  null ones; sorted in descending order, a token takes the shortest prefix
  whose sum reaches ``top_p``, at most ``top_k`` slots (``route``);
  y = sum of the shared experts + sum over the chosen routed experts of
  p_i E_i(n), with E(n) = W_down(silu(W_gate n) * W_up n); a null expert
  adds nothing, the weights are p itself (not renormalised), the shared
  experts carry no gate, and no token is dropped;
- output: a final RMSNorm and the untied head, logits in the compute
  dtype cast to float32.

The parameter tree (``init_params``): ``tower`` {``encoder``: Whisper's},
``connector`` {w (d_audio, D), b}, ``embed`` (V, D), ``layers``: [{
``attn_norm`` (D,), ``q``/``k``/``v`` {w (D, out), b}, ``o`` {w},
``mlp_norm`` (D,), ``router`` (D, n_slots) float32, ``shared_w1`` (S, D,
2 Fs) and ``experts_w1`` (E, D, 2 F) holding [W_gate | W_up] side by side,
``shared_w2`` (S, Fs, D), ``experts_w2`` (E, F, D)}], ``norm`` (D,),
``head`` (D, V). The language model is stored in bfloat16 at full size
(float32 would not fit one card); the tower keeps float32 and casts per
call, as Whisper's encoder does.

The MoE is dispatched two ways with the same arithmetic: the prefill
sorts its tokens by expert and runs each routed expert on its own rows
(``moe_grouped``, where the null expert saves work; one host read of the
group sizes a layer), and a decode step runs every routed expert over all
rows, weighted by a mask that is 0 where it was not chosen
(``moe_static``): static shapes, so the greedy loop replays the step as a
CUDA graph. Both sum the routed experts in expert order and then the
shared ones, in float32.

The cache (``LLMCache``) holds each layer's K/V (B, H_kv, T_max, Dh),
written by ``index_copy_`` at a device position, and the slots each token
was routed to (``routes``, -1 where no token has been). While spans record
(``utils.timing.recording``) a routing counter sums, per layer and for the
prefill and the decode steps apart, the tokens each slot received, the
tokens routed and the expert-GEMM rows computed, on the device; the
decode front end reads it back once after the call (``routing_records``).

Spans: ``llm.init_cache``, ``llm.connector``, ``llm.prefill`` with one
``llm.prefill.moe`` a layer inside it, and ``llm.decode.moe`` a layer in a
decode step that runs eagerly (a replayed graph runs no Python, but
launches the same kernels).
"""

from __future__ import annotations

import collections
from dataclasses import replace
from typing import Dict, List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ..config import AudioLLMConfig
from ..ops.precision import full_fp32
from ..utils import timing
from .convert import params_to
from .layers import apply_rope, gqa_attention, linear, rms_norm, rope_tables
from .whisper import encode
from .whisper import init_params as whisper_init_params

Params = Dict


# -- initialization -------------------------------------------------------

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def init_params(cfg: AudioLLMConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> Params:
    """Seeded random weights drawn on the CPU, moved to ``device``: the
    tower as ``whisper.init_params`` draws Whisper's encoder (float32), the
    language model in ``dtype`` (the routers float32): linear weights N(0,
    in^-0.5), biases N(0, 0.02), norm gains 1 + N(0, 0.02), the embedding
    N(0, 0.02). For small configurations (tests); the benchmark draws
    full-size weights on the card."""
    tower = {"encoder": whisper_init_params(replace(cfg.tower, n_text_layer=0),
                                            seed)["encoder"]}
    gen = torch.Generator().manual_seed(seed + 1)
    D, Dh = cfg.d_model, cfg.head_dim

    def normal(shape, std, to=dtype):
        return _normal(gen, shape, std).to(to)

    def lin(d_in, d_out, bias=True):
        p = {"w": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = normal((d_out,), 0.02)
        return p

    def gain(d):
        return (1.0 + _normal(gen, (d,), 0.02)).to(dtype)

    layers = []
    for _ in range(cfg.n_layer):
        layers.append({
            "attn_norm": gain(D),
            "q": lin(D, cfg.n_head * Dh), "k": lin(D, cfg.n_kv_head * Dh),
            "v": lin(D, cfg.n_kv_head * Dh), "o": lin(cfg.n_head * Dh, D, bias=False),
            "mlp_norm": gain(D),
            "router": normal((D, cfg.n_slots), D ** -0.5, torch.float32),
            "shared_w1": normal((cfg.n_shared, D, 2 * cfg.shared_ffn), D ** -0.5),
            "shared_w2": normal((cfg.n_shared, cfg.shared_ffn, D), cfg.shared_ffn ** -0.5),
            "experts_w1": normal((cfg.n_routed, D, 2 * cfg.routed_ffn), D ** -0.5),
            "experts_w2": normal((cfg.n_routed, cfg.routed_ffn, D), cfg.routed_ffn ** -0.5),
        })
    params = {
        "tower": tower,
        "connector": lin(cfg.tower.n_audio_state, D),
        "embed": normal((cfg.n_vocab, D), 0.02),
        "layers": layers,
        "norm": gain(D),
        "head": normal((D, cfg.n_vocab), D ** -0.5),
    }
    return params if device is None else params_to(params, device)


# -- routing --------------------------------------------------------------

class Routes(NamedTuple):
    """A token's choice (N rows): ``slots`` (N, top_k) long, the slot or
    ``n_slots`` where the token took fewer; ``weights`` (N, top_k) float32,
    its probability or 0."""

    slots: torch.Tensor
    weights: torch.Tensor


def route(n, router, cfg: AudioLLMConfig) -> Routes:
    """Capped top-p routing in float32: softmax over the slots, sorted in
    descending order (a stable sort: the lower slot first on a tie); a
    sorted entry is taken while the sum of the entries before it is under
    ``top_p``, at most ``top_k`` of them."""
    p = torch.softmax(n.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    before = torch.cat([torch.zeros_like(vals[:, :1]),
                        torch.cumsum(vals[:, :k - 1], dim=-1)], dim=-1)
    keep = before < cfg.top_p
    slots = torch.where(keep, idx[:, :k], torch.full_like(idx[:, :k], cfg.n_slots))
    weights = torch.where(keep, vals[:, :k], torch.zeros_like(vals[:, :k]))
    return Routes(slots, weights)


def _swiglu(x, w1, w2):
    """W_down(silu(W_gate x) * W_up x) over (..., N, D), ``w1`` holding
    [W_gate | W_up]; batched over experts when the weights are."""
    h = torch.matmul(x, w1)
    f = h.shape[-1] // 2
    return torch.matmul(F.silu(h[..., :f]) * h[..., f:], w2)


def _shared(p, n):
    """The shared experts over every row, summed in float32."""
    out = _swiglu(n.expand(p["shared_w1"].shape[0], *n.shape),
                  p["shared_w1"].to(n.dtype), p["shared_w2"].to(n.dtype))
    y = out[0].float()
    for o in out[1:]:
        y = y + o.float()
    return y


def moe_grouped(p, n, r: Routes, cfg: AudioLLMConfig, counts=None):
    """The MoE over (N, D) rows, grouped: the (row, slot) picks sorted by
    slot, each routed expert run over its own rows only, its output times
    the row's probability added in float32; then the shared experts. One
    host read of the group sizes. ``counts`` (n_slots + 3,): the routing
    counter's row of this layer and phase."""
    N, K = r.slots.shape
    flat = r.slots.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sizes_t = torch.bincount(flat, minlength=cfg.n_slots + 1)
    sizes = sizes_t.tolist()
    rows_of = order // K
    w_of = r.weights.reshape(-1)[order]
    y = torch.zeros((N, n.shape[-1]), dtype=torch.float32, device=n.device)
    start = 0
    for e in range(cfg.n_routed):
        end = start + sizes[e]
        if end > start:
            rows = rows_of[start:end]
            o = _swiglu(n.index_select(0, rows), p["experts_w1"][e].to(n.dtype),
                        p["experts_w2"][e].to(n.dtype))
            y.index_add_(0, rows, o.float() * w_of[start:end, None])
        start = end
    if counts is not None:
        counts[:cfg.n_slots + 1] += sizes_t
        counts[cfg.n_slots + 1] += sum(sizes[:cfg.n_routed])
        counts[cfg.n_slots + 2] += N
    return (y + _shared(p, n)).to(n.dtype)


def moe_static(p, n, r: Routes, cfg: AudioLLMConfig, counts=None):
    """The MoE over (N, D) rows with static shapes: every routed expert
    over every row (one batched product over the experts), each output
    times the row's probability of that expert, 0 where the row did not
    choose it, added in expert order in float32; then the shared experts.
    Reads nothing on the host."""
    N = n.shape[0]
    E = cfg.n_routed
    w = torch.zeros((N, cfg.n_slots + 1), dtype=torch.float32, device=n.device)
    w.scatter_(1, r.slots, r.weights)
    out = _swiglu(n.expand(E, *n.shape), p["experts_w1"].to(n.dtype),
                  p["experts_w2"].to(n.dtype))
    y = torch.zeros((N, n.shape[-1]), dtype=torch.float32, device=n.device)
    for e in range(E):
        y = y + out[e].float() * w[:, e:e + 1]
    if counts is not None:
        ones = torch.ones_like(r.slots.reshape(-1))
        counts.index_add_(0, r.slots.reshape(-1), ones)
        counts[cfg.n_slots + 1] += N * E
        counts[cfg.n_slots + 2] += N
    return (y + _shared(p, n)).to(n.dtype)


# -- the cache and the routing counter ------------------------------------

class LLMCache(NamedTuple):
    """k, v: (L, B, H_kv, T_max, Dh) in the compute dtype; cos, sin:
    (T_max, Dh) float32 RoPE tables; routes: (L, B, T_max, top_k) int8,
    each position's slots (``n_slots`` where it took fewer; -1 where
    nothing ran); counts: (2, L, n_slots + 3) int64, the routing counter,
    [prefill | decode] x layer x [tokens each slot received (the last
    column of the slots: picks not taken), expert-GEMM rows computed,
    tokens routed], or None where spans do not record."""

    k: torch.Tensor
    v: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    routes: torch.Tensor
    counts: Optional[torch.Tensor]


def init_cache(cfg: AudioLLMConfig, batch: int, max_len: int, dtype,
               device) -> LLMCache:
    L = cfg.n_layer
    shape = (L, batch, cfg.n_kv_head, max_len, cfg.head_dim)
    cos, sin = rope_tables(max_len, cfg.head_dim, cfg.rope_theta, device)
    counts = None
    if timing.recording():
        counts = torch.zeros((2, L, cfg.n_slots + 3), dtype=torch.long, device=device)
    return LLMCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        cos=cos, sin=sin,
        routes=torch.full((L, batch, max_len, cfg.top_k), -1, dtype=torch.int8,
                          device=device),
        counts=counts,
    )


class RoutingRecord(NamedTuple):
    """One decode call's routing counter, read back after it: ``call`` the
    id of the outermost span it ran in (``utils.timing``), ``prefill`` and
    ``decode`` each [layer][column] as in ``LLMCache.counts``."""

    call: Optional[int]
    prefill: List[List[int]]
    decode: List[List[int]]


_ROUTING = collections.deque(maxlen=256)


def record_routing(cache: LLMCache) -> None:
    """Read the call's routing counter back (one copy) and keep it."""
    if cache.counts is None:
        return
    span = timing.current()
    counts = cache.counts.cpu().tolist()
    _ROUTING.append(RoutingRecord(span.call if span else None, counts[0], counts[1]))


def routing_records() -> List[RoutingRecord]:
    """The routing counters of the latest calls made while spans recorded
    (at most 256), oldest first."""
    return list(_ROUTING)


# -- the forward ----------------------------------------------------------

def connector(params: Params, cfg: AudioLLMConfig, features, dtype):
    """(B, T_a, d_audio) encoder frames -> (B, n_audio_tokens, D)."""
    with timing.span("llm.connector"):
        pooled = F.adaptive_avg_pool1d(features.float().transpose(1, 2),
                                       cfg.n_audio_tokens).transpose(1, 2)
        return linear(pooled.to(dtype), params["connector"])


class _At(NamedTuple):
    """Where a forward runs, made once for all its layers: ``pos`` the
    first position (0 in the prefill; a (1,) device tensor in a decode
    step), the RoPE tables at its positions, the additive attention mask,
    and whether it is a decode step."""

    pos: Union[int, torch.Tensor]
    cos: torch.Tensor
    sin: torch.Tensor
    mask: torch.Tensor
    decode: bool


def _prefill_at(cache: LLMCache, T: int) -> _At:
    mask = torch.full((T, T), float("-inf"), device=cache.k.device).triu(1)
    return _At(0, cache.cos[:T], cache.sin[:T], mask, False)


def _decode_at(cache: LLMCache, pos: torch.Tensor) -> _At:
    key_idx = torch.arange(cache.k.shape[3], device=pos.device)
    mask = torch.where(key_idx > pos, float("-inf"), 0.0)
    return _At(pos, cache.cos.index_select(0, pos), cache.sin.index_select(0, pos),
               mask, True)


def _layer(p, cfg: AudioLLMConfig, x, cache: LLMCache, l: int, at: _At):
    """One layer over x (B, T, D) at positions [at.pos, at.pos + T): the
    attention (its K/V written into the cache), then the MoE, grouped in
    the prefill and static in a decode step."""
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q = linear(h, p["q"]).view(B, T, H, Dh).transpose(1, 2)
    k = linear(h, p["k"]).view(B, T, Hkv, Dh).transpose(1, 2)
    v = linear(h, p["v"]).view(B, T, Hkv, Dh).transpose(1, 2)
    q, k = apply_rope(q, at.cos, at.sin), apply_rope(k, at.cos, at.sin)
    if at.decode:  # one position, at the device value at.pos (1,)
        cache.k[l].index_copy_(2, at.pos, k)
        cache.v[l].index_copy_(2, at.pos, v)
        a = gqa_attention(q, cache.k[l], cache.v[l], at.mask)
    else:
        cache.k[l][:, :, :T] = k
        cache.v[l][:, :, :T] = v
        a = gqa_attention(q, k, v, at.mask)
    x = x + linear(a.transpose(1, 2).reshape(B, T, H * Dh), p["o"])

    n = rms_norm(x, p["mlp_norm"], cfg.rms_eps).reshape(B * T, -1)
    counts = None
    if cache.counts is not None and timing.recording():
        counts = cache.counts[int(at.decode), l]
    if at.decode:
        with timing.span("llm.decode.moe"):
            r = route(n, p["router"], cfg)
            cache.routes[l].index_copy_(1, at.pos, r.slots.view(B, 1, -1).to(torch.int8))
            y = moe_static(p, n, r, cfg, counts)
    else:
        with timing.span("llm.prefill.moe"):
            r = route(n, p["router"], cfg)
            cache.routes[l][:, :T] = r.slots.view(B, T, -1).to(torch.int8)
            y = moe_grouped(p, n, r, cfg, counts)
    return x + y.view(B, T, -1)


def _logits(params: Params, cfg: AudioLLMConfig, x):
    """Final RMSNorm and the untied head: float32 logits."""
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    return (x @ params["head"].to(x.dtype)).float()


def _embed_prompt(params: Params, cfg: AudioLLMConfig, prompt_ids, audio_start: int,
                  features, dtype):
    """[Emb(ids before the audio); the connector's audio tokens; Emb(ids
    after them)]: (B, T, D)."""
    audio = connector(params, cfg, features, dtype)
    end = audio_start + cfg.n_audio_tokens
    emb = params["embed"]
    return torch.cat([emb[prompt_ids[:, :audio_start]].to(dtype), audio,
                      emb[prompt_ids[:, end:]].to(dtype)], dim=1)


def _prefill_layers(params: Params, cfg: AudioLLMConfig, x, cache: LLMCache):
    at = _prefill_at(cache, x.shape[1])
    for l, p in enumerate(params["layers"]):
        x = _layer(p, cfg, x, cache, l, at)
    return x


def prefill(params: Params, cfg: AudioLLMConfig, prompt_ids, audio_start: int,
            features, cache: LLMCache, dtype):
    """The prompt through every layer: ``prompt_ids`` (B, T) with the
    ``n_audio_tokens`` audio slots from ``audio_start`` (their ids are not
    read), ``features`` the tower's frames. Fills the cache's positions
    [0, T); returns the last position's logits (B, 1, V) float32."""
    with full_fp32():
        x = _embed_prompt(params, cfg, prompt_ids, audio_start, features, dtype)
        with timing.span("llm.prefill"):
            x = _prefill_layers(params, cfg, x, cache)
            return _logits(params, cfg, x[:, -1:])


def decode_step(params: Params, cfg: AudioLLMConfig, tokens, cache: LLMCache,
                pos: Union[int, torch.Tensor], dtype):
    """One token a row, ``tokens`` (B, 1) at position ``pos`` (a Python int
    or a 0-d long tensor on the device: the step reads no value on the
    host, so a CUDA graph captured with it replays at whatever position the
    tensor then holds). Returns logits (B, 1, V) float32."""
    with full_fp32():
        pos = torch.as_tensor(pos, device=tokens.device).reshape(1)
        x = params["embed"][tokens].to(dtype)
        at = _decode_at(cache, pos)
        for l, p in enumerate(params["layers"]):
            x = _layer(p, cfg, x, cache, l, at)
        return _logits(params, cfg, x)


def forward(params: Params, cfg: AudioLLMConfig, prompt_ids, audio_start: int,
            features, tokens, dtype=torch.float32):
    """Teacher-forced logits (B, T + S, V) float32 of the prompt followed by
    ``tokens`` (B, S): the prefill and then each token's decode step
    through a cache, every position's logits kept (tests)."""
    B, T = prompt_ids.shape
    cache = init_cache(cfg, B, T + tokens.shape[1], dtype, prompt_ids.device)
    with full_fp32():
        x = _embed_prompt(params, cfg, prompt_ids, audio_start, features, dtype)
        out = [_logits(params, cfg, _prefill_layers(params, cfg, x, cache))]
        for s in range(tokens.shape[1]):
            out.append(decode_step(params, cfg, tokens[:, s:s + 1], cache, T + s, dtype))
    return torch.cat(out, dim=1), cache


def encode_audio(params: Params, cfg: AudioLLMConfig, mel, dtype):
    """The tower: (B, 3000, n_mels) log-mel -> (B, 1500, d_audio)."""
    return encode(params["tower"], cfg.tower, mel, dtype=dtype)


__all__ = [
    "LLMCache", "Routes", "RoutingRecord", "connector",
    "decode_step", "encode_audio", "forward", "init_cache",
    "init_params", "moe_grouped", "moe_static", "prefill",
    "record_routing", "route", "routing_records",
]
