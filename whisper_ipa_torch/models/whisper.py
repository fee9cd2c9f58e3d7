"""Whisper encoder/decoder as PyTorch functions over a parameter dict tree.

Counterpart of ``whisper_ipa_tpu/models/whisper.py``, with the same
canonical tree (see ``convert.py``): conv stem + sinusoid positions +
pre-LN encoder blocks; token + learned-position embeddings + pre-LN decoder
blocks with cross-attention; logits tied to the token embedding, in f32.

PyTorch runs eagerly, so a Python loop over layers takes the place of the
reference's ``lax.scan``, and ``decode_step`` writes the new self-attention
K/V into the cache buffers in place (the reference returns an updated
cache; here the returned cache is the same object, updated).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from whisper_ipa_tpu.config import WhisperConfig

from ..ops.precision import full_fp32
from .convert import params_to
from .layers import (
    attention_block,
    causal_mask,
    conv1d,
    gelu,
    layer_norm,
    linear,
    mlp_block,
    multi_head_attention,
    multi_head_attention_int8kv,
    multi_head_attention_two_part,
    sinusoids,
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

def encode(params: Params, cfg: WhisperConfig, mel, dtype=torch.float32):
    """Audio encoder: (B, 2 * n_audio_ctx, n_mels) -> (B, n_audio_ctx, d)."""
    enc = params["encoder"]
    with full_fp32():
        x = mel.to(dtype)
        x = gelu(conv1d(x, enc["conv1"], stride=1))
        x = gelu(conv1d(x, enc["conv2"], stride=2))
        pos = torch.from_numpy(sinusoids(cfg.n_audio_ctx, cfg.n_audio_state))
        x = x + pos.to(device=x.device, dtype=dtype)
        for block in enc["blocks"]:
            h, _ = attention_block(
                layer_norm(x, block["attn_ln"]), block["attn"], cfg.n_audio_head
            )
            x = x + h
            x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return layer_norm(x, enc["ln_post"])


# -- decoder (teacher forcing / full sequence) ----------------------------

def decoder_hidden(params: Params, cfg: WhisperConfig, tokens, audio_features,
                   dtype=torch.float32):
    """Decoder final hidden states (B, T, d), before the logits product."""
    dec = params["decoder"]
    T = tokens.shape[1]
    with full_fp32():
        x = dec["token_embedding"][tokens].to(dtype)
        x = x + dec["positional_embedding"][:T].to(dtype)
        mask = causal_mask(T, device=x.device)
        audio_features = audio_features.to(dtype)
        for block in dec["blocks"]:
            xa_k = linear(audio_features, block["cross_attn"]["key"])
            xa_v = linear(audio_features, block["cross_attn"]["value"])
            h, _ = attention_block(
                layer_norm(x, block["attn_ln"]), block["attn"],
                cfg.n_text_head, mask=mask,
            )
            x = x + h
            h, _ = attention_block(
                layer_norm(x, block["cross_attn_ln"]), block["cross_attn"],
                cfg.n_text_head, kv=(xa_k, xa_v),
            )
            x = x + h
            x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return layer_norm(x, dec["ln"])


def decoder_logits(params: Params, cfg: WhisperConfig, tokens, audio_features,
                   dtype=torch.float32):
    """Teacher-forced decoder: (B, T) x (B, T_a, d) -> (B, T, n_vocab) f32."""
    x = decoder_hidden(params, cfg, tokens, audio_features, dtype=dtype)
    with full_fp32():
        return x.float() @ params["decoder"]["token_embedding"].float().T


# -- decoder (incremental, KV-cached) -------------------------------------

class DecoderCache(NamedTuple):
    """KV cache for incremental decoding, in the reference's layouts.

    self_k/self_v: (L, B, n_ctx, d), written in place by ``decode_step``.
    cross_k/cross_v: (L, B, T_a, d) in the compute dtype, or, with an int8
    cross cache, head-split T-minor codes (L, B, H, Dh, T_pad) int8 with
    cross_k_scale/cross_v_scale (L, B, H, T_pad) f32; T_pad is T_a rounded
    up to 128 and scale 0 marks a padded position.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None


def _quantize_kv_heads(x, n_head: int):
    """Symmetric int8 per-(position, head) quantization, T-minor layout.

    (B, T, d) -> codes (B, H, Dh, T_pad) int8, scales (B, H, T_pad) f32:
    scale = max(amax over Dh, 1e-8) / 127, codes rounded half to even, T
    padded to a multiple of 128 with code 0 and scale 0.
    """
    B, T, d = x.shape
    dh = d // n_head
    xf = x.transpose(1, 2).float().reshape(B, n_head, dh, T)
    amax = xf.abs().amax(dim=2)  # (B, H, T)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    codes = torch.round(xf / scale[:, :, None, :]).to(torch.int8)
    t_pad = ((T + 127) // 128) * 128
    if t_pad != T:
        codes = torch.nn.functional.pad(codes, (0, t_pad - T))
        scale = torch.nn.functional.pad(scale, (0, t_pad - T))
    return codes.contiguous(), scale.contiguous()


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


def init_cache(
    params: Params,
    cfg: WhisperConfig,
    audio_features,
    max_len: Optional[int] = None,
    dtype=torch.float32,
    cross_kv_int8: bool = False,
) -> DecoderCache:
    """Allocate the self-attention buffers and project the cross K/V once
    per layer (int8-quantized when ``cross_kv_int8``)."""
    B = audio_features.shape[0]
    L = cfg.n_text_layer
    n_ctx = max_len or cfg.n_text_ctx
    d = cfg.n_text_state
    device = audio_features.device
    audio_features = audio_features.to(dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    k_scales: List[torch.Tensor] = []
    v_scales: List[torch.Tensor] = []
    with full_fp32():
        # one layer at a time: the float projection transient stays one
        # layer's (B, T_a, d)
        for block in params["decoder"]["blocks"]:
            k = linear(audio_features, block["cross_attn"]["key"])
            v = linear(audio_features, block["cross_attn"]["value"])
            if cross_kv_int8:
                k, k_s = _quantize_kv_heads(k, cfg.n_text_head)
                v, v_s = _quantize_kv_heads(v, cfg.n_text_head)
                k_scales.append(k_s)
                v_scales.append(v_s)
            ks.append(k)
            vs.append(v)
    return DecoderCache(
        self_k=torch.zeros((L, B, n_ctx, d), dtype=dtype, device=device),
        self_v=torch.zeros((L, B, n_ctx, d), dtype=dtype, device=device),
        cross_k=torch.stack(ks),
        cross_v=torch.stack(vs),
        cross_k_scale=torch.stack(k_scales) if cross_kv_int8 else None,
        cross_v_scale=torch.stack(v_scales) if cross_kv_int8 else None,
    )


def _cross_attn_default(cfg: WhisperConfig):
    """Cross-attention policy: the int8 T-minor cache when scales are
    present, full precision otherwise."""

    def cross_attn(qc, xk, xv, k_scale, v_scale):
        if k_scale is not None:
            return multi_head_attention_int8kv(
                qc, xk, k_scale, xv, v_scale, cfg.n_text_head
            )
        return multi_head_attention(qc, xk, xv, cfg.n_text_head)

    return cross_attn


def _run_decoder_layers(dec, cfg: WhisperConfig, x, cache: DecoderCache,
                        self_attn, cross_attn):
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
        x = x + linear(h, block["attn"]["out"])

        xn = layer_norm(x, block["cross_attn_ln"])
        qc = linear(xn, block["cross_attn"]["query"])
        scales = (
            (cache.cross_k_scale[i], cache.cross_v_scale[i])
            if cache.cross_k_scale is not None
            else (None, None)
        )
        h = cross_attn(qc, cache.cross_k[i], cache.cross_v[i], *scales)
        x = x + linear(h, block["cross_attn"]["out"])

        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
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

        def self_attn(q, k_cache, v_cache, k_new, v_new):
            return multi_head_attention_two_part(
                q, k_cache, v_cache, k_new, v_new,
                cfg.n_text_head, mask_cache, mask_new,
            )

        x, news = _run_decoder_layers(
            dec, cfg, x, cache, self_attn, _cross_attn_default(cfg)
        )
        for i, (k_new, v_new) in enumerate(news):
            cache.self_k[i, :, pos:pos + S] = k_new
            cache.self_v[i, :, pos:pos + S] = v_new
        step_logits = _final_logits(dec, x)
    return step_logits, cache
