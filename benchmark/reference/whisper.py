"""Whisper's encoder, teacher-forced decoder and loss in plain PyTorch.

The published architecture: two GELU convolutions (the second of stride
2) and sinusoidal positions in front of pre-LN encoder blocks; token and
learned position embeddings, pre-LN decoder blocks with causal self-
attention and cross-attention over the audio features, a final LayerNorm
and logits tied to the token embedding. LayerNorm eps 1e-5, exact GELU,
scaled dot-product attention with 1/sqrt(d_head), softmax in float32.

Parameters are a tree in the harness's layout: ``linear`` groups hold
``w`` (in, out) and ``b`` (the key projection has no bias), convolutions
``w`` (width, in, out), LayerNorms ``g`` and ``b``.

Every product goes through ``precision.mm``, so the same code runs the
float32 reference and its lower-precision control. Where a configuration
states an int8 cross-attention cache, the decoder rounds the cross keys
and values as that cache does (``int8_per_head``), in float32 otherwise.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .precision import FP32, Precision


def full_fp32() -> None:
    """No TF32 on the card: float32 products in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps=1e-5)


def linear(x, p, prec: Precision):
    y = prec.mm(x, p["w"])
    return y + p["b"] if p.get("b") is not None else y


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1)).float()


def conv1d(x, p, stride: int, prec: Precision):
    """Width-3 convolution with padding 1 over (B, T, C), as one product of
    each output frame's three input frames."""
    xp = F.pad(x, (0, 0, 1, 1))
    win = xp.unfold(1, 3, stride)  # (B, T_out, C, 3)
    win = win.permute(0, 1, 3, 2).reshape(x.shape[0], win.shape[1], -1)
    w = p["w"].reshape(-1, p["w"].shape[-1])  # (3 * C, out), width-major
    return prec.mm(win, w) + p["b"]


def int8_per_head(x, n_head: int):
    """Symmetric int8 rounding per (row, position, head), as an int8 cache
    stores keys and values: scale = max(|x| over the head's width, 1e-8)
    / 127, x rounded half to even to a multiple of it."""
    B, T, d = x.shape
    xh = x.reshape(B, T, n_head, d // n_head)
    scale = torch.clamp_min(xh.abs().amax(-1, keepdim=True), 1e-8) / 127.0
    return (torch.round(xh / scale) * scale).reshape(B, T, d)


def attention(x, kv, p, n_head: int, prec: Precision, causal: bool,
              kv_int8: bool = False):
    q = linear(x, p["query"], prec)
    k = linear(kv, p["key"], prec)
    v = linear(kv, p["value"], prec)
    if kv_int8:
        k, v = int8_per_head(k, n_head), int8_per_head(v, n_head)
    B, T, d = q.shape
    dh = d // n_head

    def heads(t):
        return t.reshape(B, t.shape[1], n_head, dh).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = prec.mm(q * dh ** -0.5, k.transpose(-1, -2)).float()
    if causal:
        mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    out = prec.mm(w, v).transpose(1, 2).reshape(B, T, d)
    return linear(out, p["out"], prec)


def mlp(x, block, prec: Precision):
    return linear(F.gelu(linear(x, block["mlp1"], prec)), block["mlp2"], prec)


def encode(params: Dict, n_head: int, mel, prec: Precision = FP32):
    """(B, 3000, n_mels) log-mel -> (B, 1500, d) audio features."""
    enc = params["encoder"]
    x = F.gelu(conv1d(mel, enc["conv1"], 1, prec))
    x = F.gelu(conv1d(x, enc["conv2"], 2, prec))
    x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
    for block in enc["blocks"]:
        h = layer_norm(x, block["attn_ln"])
        x = x + attention(h, h, block["attn"], n_head, prec, causal=False)
        x = x + mlp(layer_norm(x, block["mlp_ln"]), block, prec)
    return layer_norm(x, enc["ln_post"])


def encode_blocks(params: Dict, n_head: int, mel, rows: int = 8,
                  prec: Precision = FP32):
    """``encode`` a few rows at a time, without autograd, so that the
    float32 attention scores of one block fit beside everything else."""
    with torch.no_grad():
        return torch.cat([encode(params, n_head, mel[i:i + rows], prec)
                          for i in range(0, mel.shape[0], rows)])


def decoder_logits(params: Dict, n_head: int, tokens, features,
                   prec: Precision = FP32, cross_int8: bool = False):
    """Teacher-forced decoder: (B, T) ids over (B, 1500, d) features ->
    (B, T, n_vocab) float32 logits. ``cross_int8``: the cross-attention's
    keys and values rounded as an int8 cache stores them."""
    dec = params["decoder"]
    T = tokens.shape[1]
    x = dec["token_embedding"][tokens] + dec["positional_embedding"][:T]
    for block in dec["blocks"]:
        h = layer_norm(x, block["attn_ln"])
        x = x + attention(h, h, block["attn"], n_head, prec, causal=True)
        h = layer_norm(x, block["cross_attn_ln"])
        x = x + attention(h, features, block["cross_attn"], n_head, prec,
                          causal=False, kv_int8=cross_int8)
        x = x + mlp(layer_norm(x, block["mlp_ln"]), block, prec)
    x = layer_norm(x, dec["ln"])
    return prec.mm(x, dec["token_embedding"].T).float()


def loss_mask(targets, eot: int):
    """Every target up to and including each row's first EOT."""
    is_eot = targets == eot
    return (~is_eot) | (torch.cumsum(is_eot.int(), dim=1) == 1)


def loss(params: Dict, n_head: int, tokens, features, eot: int,
         prec: Precision = FP32):
    """Mean cross-entropy of the next token over the masked targets."""
    logits = decoder_logits(params, n_head, tokens[:, :-1], features, prec)
    targets = tokens[:, 1:]
    mask = loss_mask(targets, eot)
    lp = torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    return -(lp * mask).sum() / mask.sum().clamp_min(1)
