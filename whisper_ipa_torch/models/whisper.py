"""Whisper encoder/decoder as PyTorch functions over a parameter dict tree.

Counterpart of ``whisper_ipa_tpu/models/whisper.py``, with the same
canonical tree (see ``convert.py``): conv stem + sinusoid positions +
pre-LN encoder blocks; token + learned-position embeddings + pre-LN decoder
blocks with cross-attention; logits tied to the token embedding, in f32.

PyTorch runs eagerly, so a Python loop over layers takes the place of the
reference's ``lax.scan``, and ``decode_step`` writes the new self-attention
K/V into the cache buffers in place (the reference returns an updated
cache; here the returned cache is the same object, updated). ``remat``
wraps each layer in ``torch.utils.checkpoint`` where the reference wraps
its scan body in ``jax.checkpoint``.

Tensor parallelism: the functions that take ``tp`` (a
``parallel.sharded.TensorParallel``, None without it) run on the rank's
Megatron blocks of the parameters (``parallel.shard_params``) with the
rank's share of the heads, ``cfg``'s head count over ``tp.size``; the
head width stays ``cfg``'s. The layer norms, the embeddings and the f32
logits are replicated, so every rank computes the same logits. A layer
whose parameters are FSDP slices (``parallel.sharded.FSDPBlock``)
gathers them where it runs, and again when its backward recomputes it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import WhisperConfig
from ..ops.kv_init import fused_kv_init_int8, quantize_kv_heads
from ..ops.precision import div_ieee, full_fp32
from ..parallel.sharded import FSDPBlock, copy_to_tp, local_heads
from .convert import flatten_params, params_to
from .layers import (
    attention_block,
    causal_mask,
    conv1d,
    gelu,
    layer_norm,
    linear,
    mlp_block,
    merge_heads,
    row_linear,
    multi_head_attention,
    multi_head_attention_beam_cache,
    multi_head_attention_int8kv,
    multi_head_attention_two_part,
    sinusoids,
    split_heads,
)

Params = Dict[str, Any]


# -- initialization -------------------------------------------------------

class _Init:
    """Seeded random init with the reference's shapes and scales; the
    numbers differ from ``jax.random``'s (a different generator)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cpu").manual_seed(seed)

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, dtype=torch.float32) * std

    def linear(self, d_in: int, d_out: int, bias: bool = True) -> Params:
        p = {"w": self.normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros(d_out)
        return p

    @staticmethod
    def ln(d: int) -> Params:
        return {"g": torch.ones(d), "b": torch.zeros(d)}

    def attn(self, d: int) -> Params:
        return {
            "query": self.linear(d, d),
            "key": self.linear(d, d, bias=False),
            "value": self.linear(d, d),
            "out": self.linear(d, d),
        }

    def block(self, d: int, mlp_dim: int, cross: bool) -> Params:
        block = {
            "attn_ln": self.ln(d),
            "attn": self.attn(d),
            "mlp_ln": self.ln(d),
            "mlp1": self.linear(d, mlp_dim),
            "mlp2": self.linear(mlp_dim, d),
        }
        if cross:
            block["cross_attn_ln"] = self.ln(d)
            block["cross_attn"] = self.attn(d)
        return block


def init_params(cfg: WhisperConfig, seed: int = 0, device=None) -> Params:
    """Random-initialized float32 tree, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so every device gets the same
    numbers) and then moved to ``device``."""
    init = _Init(seed)
    d_a, d_t = cfg.n_audio_state, cfg.n_text_state
    encoder = {
        "conv1": {
            "w": init.normal((3, cfg.n_mels, d_a), (3 * cfg.n_mels) ** -0.5),
            "b": torch.zeros(d_a),
        },
        "conv2": {
            "w": init.normal((3, d_a, d_a), (3 * d_a) ** -0.5),
            "b": torch.zeros(d_a),
        },
        "blocks": [
            init.block(d_a, 4 * d_a, cross=False)
            for _ in range(cfg.n_audio_layer)
        ],
        "ln_post": init.ln(d_a),
    }
    decoder = {
        "token_embedding": init.normal((cfg.n_vocab, d_t), 0.02),
        "positional_embedding": torch.zeros(cfg.n_text_ctx, d_t),
        "blocks": [
            init.block(d_t, 4 * d_t, cross=True)
            for _ in range(cfg.n_text_layer)
        ],
        "ln": init.ln(d_t),
    }
    params = {"encoder": encoder, "decoder": decoder}
    return params if device is None else params_to(params, device)


# -- encoder --------------------------------------------------------------

def _layer(body, remat: bool, *args):
    """One layer, rematerialized in the backward when ``remat`` (always
    for a layer of FSDP slices, so the backward gathers them again)."""
    if any(isinstance(a, FSDPBlock) for a in args):
        def gathered(*a):
            return body(*[x.materialize() if isinstance(x, FSDPBlock) else x
                          for x in a])

        if torch.is_grad_enabled():
            return checkpoint(gathered, *args, use_reentrant=False)
        return gathered(*args)
    if remat:
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


@functools.lru_cache(maxsize=None)
def _audio_positions(length: int, channels: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """The encoder's sinusoidal table on ``device`` in ``dtype``, copied
    from the host once: a copy on every forward would wait for the card's
    stream in each training step."""
    with torch.inference_mode(False):  # usable by autograd after serving
        return torch.from_numpy(sinusoids(length, channels)).to(
            device=device, dtype=dtype)


def encode(params: Params, cfg: WhisperConfig, mel, dtype=torch.float32,
           remat: bool = False, tp=None):
    """Audio encoder: (B, 2 * n_audio_ctx, n_mels) -> (B, n_audio_ctx, d).

    remat=True checkpoints each encoder layer (only relevant to a full
    fine-tune: a frozen encoder runs without autograd).
    """
    enc = params["encoder"]
    H = local_heads(cfg.n_audio_head, tp)

    def body(x, block):
        h, _ = attention_block(
            layer_norm(x, block["attn_ln"]), block["attn"], H, tp=tp
        )
        x = x + h
        return x + mlp_block(layer_norm(x, block["mlp_ln"]), block, tp)

    with full_fp32():
        x = mel.to(dtype)
        x = gelu(conv1d(x, enc["conv1"], stride=1))
        x = gelu(conv1d(x, enc["conv2"], stride=2))
        x = x + _audio_positions(cfg.n_audio_ctx, cfg.n_audio_state,
                                 x.device, dtype)
        for block in enc["blocks"]:
            x = _layer(body, remat, x, block)
        return layer_norm(x, enc["ln_post"])


# alias matching the reference surface (model.embed_audio)
embed_audio = encode


# -- decoder (teacher forcing / full sequence) ----------------------------

def decoder_hidden(params: Params, cfg: WhisperConfig, tokens, audio_features,
                   dtype=torch.float32, remat: bool = False, tp=None):
    """Decoder final hidden states (B, T, d), before the logits product.

    remat=True checkpoints each layer, its cross K/V projections included
    (they stay inside the layer, as in the reference).
    """
    dec = params["decoder"]
    T = tokens.shape[1]
    H = local_heads(cfg.n_text_head, tp)

    def body(x, block, audio_features, mask):
        xa_k = linear(audio_features, block["cross_attn"]["key"])
        xa_v = linear(audio_features, block["cross_attn"]["value"])
        h, _ = attention_block(
            layer_norm(x, block["attn_ln"]), block["attn"],
            H, mask=mask, tp=tp,
        )
        x = x + h
        h, _ = attention_block(
            layer_norm(x, block["cross_attn_ln"]), block["cross_attn"],
            H, kv=(xa_k, xa_v), tp=tp,
        )
        x = x + h
        return x + mlp_block(layer_norm(x, block["mlp_ln"]), block, tp)

    with full_fp32():
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][:T].to(dtype)
        mask = causal_mask(T, device=x.device)
        # the cross K/V are column-parallel products of the features
        audio_features = copy_to_tp(audio_features.to(dtype), tp)
        for block in dec["blocks"]:
            x = _layer(body, remat, x, block, audio_features, mask)
        return layer_norm(x, dec["ln"])


def decoder_logits(params: Params, cfg: WhisperConfig, tokens, audio_features,
                   dtype=torch.float32, remat: bool = False,
                   bf16_head: bool = False, tp=None):
    """Teacher-forced decoder: (B, T) x (B, T_a, d) -> (B, T, n_vocab) f32.

    bf16_head: round the logits product's two operands to bfloat16 and
    accumulate in float32, as the reference's bf16 operands with
    ``preferred_element_type=float32`` (the logits stay float32).
    """
    x = decoder_hidden(params, cfg, tokens, audio_features, dtype=dtype,
                       remat=remat, tp=tp)
    emb = params["decoder"]["token_embedding"]
    with full_fp32():
        if bf16_head:
            return (x.to(torch.bfloat16).float()
                    @ emb.to(torch.bfloat16).float().T)
        return x.float() @ emb.float().T


logits = decoder_logits  # reference-surface alias (model.logits)


def decoder_cross_attentions(params: Params, cfg: WhisperConfig, tokens,
                             audio_features, dtype=torch.float32):
    """Teacher-forced forward that also returns the cross-attention weights.

    Returns (logits (B, T, V) f32, weights (L, B, H, T, T_a) f32): the
    alignment signal of the phone timestamps (``decode/word_timestamps``).
    Plain PyTorch, as the reference's einsums.
    """
    dec = params["decoder"]
    T = tokens.shape[1]
    H = cfg.n_text_head
    scale = cfg.n_text_head_dim ** -0.25
    weights = []
    with full_fp32():
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][:T].to(dtype)
        mask = causal_mask(T, device=x.device)
        audio_features = audio_features.to(dtype)
        for block in dec["blocks"]:
            h, _ = attention_block(layer_norm(x, block["attn_ln"]),
                                   block["attn"], H, mask=mask)
            x = x + h
            xn = layer_norm(x, block["cross_attn_ln"])
            cross = block["cross_attn"]
            q = split_heads(linear(xn, cross["query"]), H) * scale
            k = split_heads(linear(audio_features, cross["key"]), H) * scale
            v = split_heads(linear(audio_features, cross["value"]), H)
            w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float(), -1)
            out = torch.matmul(w.to(v.dtype), v)
            x = x + linear(merge_heads(out), cross["out"])
            x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
            weights.append(w)
        logits = _final_logits(dec, x)
    return logits, torch.stack(weights)


# -- decoder (incremental, KV-cached) -------------------------------------

class DecoderCache(NamedTuple):
    """KV cache for incremental decoding, in the reference's layouts.

    self_k/self_v: (L, B, n_ctx, d), written in place by ``decode_step``.
    cross_k/cross_v: (L, B, T_a, d) in the compute dtype, or, with an int8
    cross cache, head-split T-minor codes (L, B, H, Dh, T_pad) int8 with
    cross_k_scale/cross_v_scale (L, B, H, T_pad) f32; T_pad is T_a rounded
    up to 128 and scale 0 marks a padded position. An int4 cross cache
    packs two T-adjacent codes a byte: (L, B, H, Dh, T_pad/2) int8, same
    scales.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None


_quantize_kv_heads = quantize_kv_heads  # the reference's name


def _quantize_kv_heads4(x, n_head: int):
    """Symmetric int4 per-(position, head) quantization, T-minor packed.

    (B, T, d) -> codes (B, H, Dh, T_pad/2) int8 (even position in the low
    nibble, odd in the high), scales (B, H, T_pad) f32: scale = max(amax
    over Dh, 1e-8) / 7, codes round(x / scale) clipped to [-7, 7], T padded
    to a multiple of 128 with code 0 and scale 0.
    """
    B, T, d = x.shape
    dh = d // n_head
    xf = x.transpose(1, 2).float().reshape(B, n_head, dh, T)
    amax = xf.abs().amax(dim=2)  # (B, H, T)
    scale = div_ieee(torch.clamp_min(amax, 1e-8), 7.0)
    codes = torch.clamp(torch.round(xf / scale[:, :, None, :]), -7, 7).to(
        torch.int8
    )
    t_pad = ((T + 127) // 128) * 128
    if t_pad != T:
        codes = torch.nn.functional.pad(codes, (0, t_pad - T))
        scale = torch.nn.functional.pad(scale, (0, t_pad - T))
    packed = (codes[..., 0::2] & 0xF) | (codes[..., 1::2] << 4)
    return packed.contiguous(), scale.contiguous()


def cast_decoder_blocks(params: Params, dtype) -> Params:
    """Decoder-block ``w``/``b`` cast once to the decode dtype.

    As in the reference: layer-norm groups (``*_ln``), the embeddings and
    the encoder keep their float32 values.
    """
    if dtype == torch.float32:
        return params

    def cast_group(group):
        if isinstance(group, dict):
            return {
                k: (
                    v.to(dtype)
                    if k in ("w", "b") and isinstance(v, torch.Tensor)
                    and v.dtype == torch.float32
                    else cast_group(v)
                )
                for k, v in group.items()
            }
        return group

    dec = dict(params["decoder"])
    dec["blocks"] = [
        {
            name: group if name.endswith("_ln") else cast_group(group)
            for name, group in block.items()
        }
        for block in dec["blocks"]
    ]
    return {**params, "decoder": dec}


_FUSED_KV_INIT = False


def use_fused_kv_init(enabled: bool) -> None:
    """Build the int8 cross cache with K3 (``ops/kv_init.py``): projection
    and quantization in one kernel on CUDA, its plain version on the CPU.
    Taken only with float cross weights and the int8 (not int4) cache."""
    global _FUSED_KV_INIT
    _FUSED_KV_INIT = enabled


def init_cache(
    params: Params,
    cfg: WhisperConfig,
    audio_features,
    max_len: Optional[int] = None,
    dtype=torch.float32,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
    tp=None,
) -> DecoderCache:
    """Allocate the self-attention buffers and project the cross K/V once
    per layer (int8- or int4-quantized when ``cross_kv_int8`` /
    ``cross_kv_int4``). With ``tp`` the cache holds the rank's heads: the
    quantization is per (position, head), so a local head's codes equal
    the unsharded ones."""
    B = audio_features.shape[0]
    L = cfg.n_text_layer
    n_ctx = max_len or cfg.n_text_ctx
    H = local_heads(cfg.n_text_head, tp)
    d = cfg.n_text_state * H // cfg.n_text_head
    device = audio_features.device
    audio_features = audio_features.to(dtype)
    quantized = cross_kv_int8 or cross_kv_int4
    quantize = _quantize_kv_heads4 if cross_kv_int4 else _quantize_kv_heads
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    k_scales: List[torch.Tensor] = []
    v_scales: List[torch.Tensor] = []
    with full_fp32():
        # one layer at a time: the float projection transient stays one
        # layer's (B, T_a, d)
        for block in params["decoder"]["blocks"]:
            pk, pv = block["cross_attn"]["key"], block["cross_attn"]["value"]
            # the reference's condition: float weights, int8 mode, switch on
            if (_FUSED_KV_INIT and cross_kv_int8 and not cross_kv_int4
                    and "w" in pk and "w" in pv):
                k, k_s, v, v_s = fused_kv_init_int8(
                    audio_features, pk["w"], pk.get("b"), pv["w"],
                    pv.get("b"), H, out_dtype=dtype,
                )
            else:
                k = linear(audio_features, pk)
                v = linear(audio_features, pv)
                if quantized:
                    k, k_s = quantize(k, H)
                    v, v_s = quantize(v, H)
            if quantized:
                k_scales.append(k_s)
                v_scales.append(v_s)
            ks.append(k)
            vs.append(v)
    return DecoderCache(
        self_k=torch.zeros((L, B, n_ctx, d), dtype=dtype, device=device),
        self_v=torch.zeros((L, B, n_ctx, d), dtype=dtype, device=device),
        cross_k=torch.stack(ks),
        cross_v=torch.stack(vs),
        cross_k_scale=torch.stack(k_scales) if quantized else None,
        cross_v_scale=torch.stack(v_scales) if quantized else None,
    )


def _cross_attn_default(cfg: WhisperConfig, tp=None):
    """Cross-attention policy: the quantized T-minor cache when scales are
    present, full precision otherwise."""
    H = local_heads(cfg.n_text_head, tp)

    def cross_attn(qc, xk, xv, k_scale, v_scale):
        if k_scale is not None:
            return multi_head_attention_int8kv(qc, xk, k_scale, xv, v_scale, H)
        return multi_head_attention(qc, xk, xv, H)

    return cross_attn


def _run_decoder_layers(dec, cfg: WhisperConfig, x, cache: DecoderCache,
                        self_attn, cross_attn, tp=None):
    """The decoder layers with pluggable attention policies.

    self_attn(q, k_cache, v_cache, k_new, v_new) and
    cross_attn(qc, xk, xv, k_scale, v_scale) take one layer's slices and
    return the merged-head output. Returns (x, [(k_new, v_new) per layer]).
    """
    news = []
    for i, block in enumerate(dec["blocks"]):
        xn = layer_norm(x, block["attn_ln"])
        q = linear(xn, block["attn"]["query"])
        k_new = linear(xn, block["attn"]["key"])
        v_new = linear(xn, block["attn"]["value"])
        h = self_attn(q, cache.self_k[i], cache.self_v[i], k_new, v_new)
        x = x + row_linear(h, block["attn"]["out"], tp)

        xn = layer_norm(x, block["cross_attn_ln"])
        qc = linear(xn, block["cross_attn"]["query"])
        scales = (
            (cache.cross_k_scale[i], cache.cross_v_scale[i])
            if cache.cross_k_scale is not None
            else (None, None)
        )
        h = cross_attn(qc, cache.cross_k[i], cache.cross_v[i], *scales)
        x = x + row_linear(h, block["cross_attn"]["out"], tp)

        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block, tp)
        news.append((k_new, v_new))
    return x, news


def _final_logits(dec, x):
    """Final LN + tied-embedding logits head (float32)."""
    x = layer_norm(x, dec["ln"])
    return x.float() @ dec["token_embedding"].float().T


def decode_step(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos: int,
    dtype=torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """One decoder step: tokens (B, S) at positions [pos, pos + S).

    Returns (logits (B, S, n_vocab) f32, cache). Each layer attends over
    [frozen cache rows < pos | the S new keys] with the reference's
    two-part mask; the new K/V then land in the cache in place.
    """
    dec = params["decoder"]
    S = tokens.shape[1]
    n_ctx = cache.self_k.shape[2]
    device = tokens.device
    with full_fp32():
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][pos:pos + S].to(dtype)

        key_idx = torch.arange(n_ctx, device=device)[None, :]
        query_idx = pos + torch.arange(S, device=device)[:, None]
        zero = torch.zeros((), device=device)
        neg = torch.full((), float("-inf"), device=device)
        # frozen cache rows: strictly before pos (rows >= pos are stale)
        mask_cache = torch.where(
            (key_idx < pos) & (key_idx <= query_idx), zero, neg
        )
        blk = torch.arange(S, device=device)
        mask_new = torch.where(blk[None, :] <= blk[:, None], zero, neg)

        H = local_heads(cfg.n_text_head, tp)

        def self_attn(q, k_cache, v_cache, k_new, v_new):
            return multi_head_attention_two_part(
                q, k_cache, v_cache, k_new, v_new, H, mask_cache, mask_new,
            )

        x, news = _run_decoder_layers(
            dec, cfg, x, cache, self_attn, _cross_attn_default(cfg, tp), tp
        )
        for i, (k_new, v_new) in enumerate(news):
            cache.self_k[i, :, pos:pos + S] = k_new
            cache.self_v[i, :, pos:pos + S] = v_new
        step_logits = _final_logits(dec, x)
    return step_logits, cache


def decode_step_beam(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos: int,
    anc,
    dtype=torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """One beam step over the unreordered self cache: tokens (B, J), one new
    token a beam at position ``pos``; anc (B, J, n_ctx), the physical row
    holding beam j's K/V at each position.

    cache.self_k/self_v: (L, B*J, n_ctx, d); the new K/V land in place at
    physical row j (``anc[b, j, pos]`` must be j). The cross cache stays at
    batch B: the J beam queries ride its query axis, so it is read once a
    step, not J times. At S = J queries the quantized cross-attention takes
    the plain path (``multi_head_attention_int8kv``), as the reference's
    einsum does; K4 and K8 are single-query.
    Returns (logits (B, J, n_vocab) f32, cache).
    """
    dec = params["decoder"]
    B, J = tokens.shape
    n_ctx = cache.self_k.shape[2]
    device = tokens.device
    H = local_heads(cfg.n_text_head, tp)
    with full_fp32():
        x = dec["token_embedding"][tokens.reshape(B * J)].to(dtype)
        x = (x + dec["positional_embedding"][pos].to(dtype)).reshape(B * J, 1, -1)
        # row anc[b, j, p] at position p < pos is beam j's history
        rows = torch.arange(J, device=device)[None, None, :, None]
        live = torch.arange(n_ctx, device=device) < pos
        sel_mask = torch.where(
            (anc[:, :, None, :] == rows) & live,
            torch.zeros((), device=device),
            torch.full((), float("-inf"), device=device),
        )  # (B, J, J, n_ctx)

        def self_attn(q, k_cache, v_cache, k_new, v_new):
            return multi_head_attention_beam_cache(
                q.reshape(B, J, -1), k_cache.reshape(B, J, n_ctx, -1),
                v_cache.reshape(B, J, n_ctx, -1), k_new.reshape(B, J, -1),
                v_new.reshape(B, J, -1), H, sel_mask,
            ).reshape(B * J, 1, -1)

        def cross_attn(qc, xk, xv, k_scale, v_scale):
            qc = qc.reshape(B, J, -1)
            if k_scale is not None:
                hc = multi_head_attention_int8kv(qc, xk, k_scale, xv, v_scale, H)
            else:
                hc = multi_head_attention(qc, xk, xv, H)
            return hc.reshape(B * J, 1, -1)

        x, news = _run_decoder_layers(dec, cfg, x, cache, self_attn,
                                      cross_attn, tp)
        for i, (k_new, v_new) in enumerate(news):
            cache.self_k[i, :, pos] = k_new[:, 0]
            cache.self_v[i, :, pos] = v_new[:, 0]
        step_logits = _final_logits(dec, x)
    return step_logits.reshape(B, J, -1), cache


def decode_step_multipos(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    dtype=torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, DecoderCache]:
    """``decode_step`` with a per-element position vector: pos (B,) long."""
    logits, cache, _ = decode_step_multipos_hidden(
        params, cfg, tokens, cache, pos, dtype=dtype, tp=tp
    )
    return logits, cache


def decode_step_multipos_hidden(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    dtype=torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """One decoder step where element b's S tokens sit at positions
    [pos[b], pos[b] + S); pos is a (B,) long tensor on the tokens' device.

    Each element attends over its own frozen cache rows < pos[b] and,
    causally, the S new keys; the new K/V then land in place at
    pos[b]:pos[b] + S with one advanced-index write per layer. Unlike the
    reference's ``dynamic_update_slice``, the write does not clamp a start
    that runs off the end: an index past n_ctx raises on the CPU and trips
    a device assert on CUDA (the in-flight engine's budget freeze keeps
    every write in range). With ``tp`` the cache holds the rank's heads
    and the hidden states are the all-reduced ones, equal on every rank.
    Returns (logits (B, S, n_vocab) f32, cache, the final-LN hidden states
    (B, S, d)).
    """
    dec = params["decoder"]
    B, S = tokens.shape
    n_ctx = cache.self_k.shape[2]
    device = tokens.device
    with full_fp32():
        pos_idx = pos[:, None] + torch.arange(S, device=device)[None, :]
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][pos_idx].to(dtype)

        key_idx = torch.arange(n_ctx, device=device)[None, None, :]
        zero = torch.zeros((), device=device)
        neg = torch.full((), float("-inf"), device=device)
        mask_cache = torch.where(
            (key_idx < pos[:, None, None]) & (key_idx <= pos_idx[:, :, None]),
            zero, neg,
        )[:, None]  # (B, 1, S, n_ctx)
        blk = torch.arange(S, device=device)
        mask_new = torch.where(blk[None, :] <= blk[:, None], zero, neg)

        H = local_heads(cfg.n_text_head, tp)

        def self_attn(q, k_cache, v_cache, k_new, v_new):
            return multi_head_attention_two_part(
                q, k_cache, v_cache, k_new, v_new, H, mask_cache, mask_new,
            )

        x, news = _run_decoder_layers(
            dec, cfg, x, cache, self_attn, _cross_attn_default(cfg, tp), tp
        )
        rows = torch.arange(B, device=device)[:, None]
        for i, (k_new, v_new) in enumerate(news):
            cache.self_k[i, rows, pos_idx] = k_new
            cache.self_v[i, rows, pos_idx] = v_new
        hidden = layer_norm(x, dec["ln"])
        step_logits = hidden.float() @ dec["token_embedding"].float().T
    return step_logits, cache, hidden



def decode_step_block(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    frontier,
    mask_new,
    write_len: int,
    dtype=torch.float32,
    tp=None,
) -> Tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """The general block step of tree verification: per-token positions,
    an explicit in-block mask and a partial K/V write.

    tokens, pos: (B, S) long; token s of row b sits at position pos[b, s]
    (siblings of a draft tree share one). frontier: (B,) long; cache rows
    < frontier[b] are frozen-valid. mask_new: additive (B, S, S) or (S, S)
    over the block. Only entries [0, write_len) land in the cache, at
    pos[b, 0] + arange(write_len) (they must be consecutive; the read-only
    draft nodes follow them). As in ``decode_step_multipos_hidden`` the
    write does not clamp a start that runs off the end; callers keep it in
    range. ``tp`` as in ``decode_step_multipos_hidden``. Returns (logits
    (B, S, n_vocab) f32, cache, the final-LN hidden states (B, S, d)).
    """
    dec = params["decoder"]
    B, S = tokens.shape
    n_ctx = cache.self_k.shape[2]
    device = tokens.device
    with full_fp32():
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][pos].to(dtype)

        key_idx = torch.arange(n_ctx, device=device)[None, None, :]
        zero = torch.zeros((), device=device)
        neg = torch.full((), float("-inf"), device=device)
        mask_cache = torch.where(
            (key_idx < frontier[:, None, None]) & (key_idx <= pos[:, :, None]),
            zero, neg,
        )[:, None]  # (B, 1, S, n_ctx)
        if mask_new.dim() == 3:
            mask_new = mask_new[:, None]  # (B, 1, S, S)

        H = local_heads(cfg.n_text_head, tp)

        def self_attn(q, k_cache, v_cache, k_new, v_new):
            return multi_head_attention_two_part(
                q, k_cache, v_cache, k_new, v_new, H, mask_cache, mask_new,
            )

        x, news = _run_decoder_layers(
            dec, cfg, x, cache, self_attn, _cross_attn_default(cfg, tp), tp
        )
        rows = torch.arange(B, device=device)[:, None]
        write_pos = pos[:, :1] + torch.arange(write_len, device=device)[None, :]
        for i, (k_new, v_new) in enumerate(news):
            cache.self_k[i, rows, write_pos] = k_new[:, :write_len]
            cache.self_v[i, rows, write_pos] = v_new[:, :write_len]
        hidden = layer_norm(x, dec["ln"])
        step_logits = hidden.float() @ dec["token_embedding"].float().T
    return step_logits, cache, hidden

# -- parameter utilities --------------------------------------------------

def count_parameters(params) -> int:
    """Number of scalars in a parameter (sub)tree."""
    return sum(int(np.prod(t.shape)) for t in flatten_params(params).values())
