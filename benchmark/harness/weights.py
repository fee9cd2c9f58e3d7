"""Seeded random weights, made on the device in a few large calls.

The tree has the layout of the program's random init
(``models.whisper.init_params``) and its scales for the weights: linear
weights (in, out) with standard deviation in**-0.5, convolutions (3, in,
out) with (3 * in)**-0.5, the token embedding 0.02. Where that init
writes constants, the harness draws small values instead, so that a
comparison sees every term: biases, LayerNorm offsets and the decoder's
positions are N(0, 0.02), LayerNorm gains 1 + N(0, 0.02). A dropped bias,
a gain or offset left out, or a position read at the wrong offset then
moves the outputs. The numbers come from one ``torch.Generator`` on the
device seeded with the run's seed: every leaf is a slice of one draw.
Both sides of a comparison get the same values by calling
``make_params`` with the same seed.
"""

from __future__ import annotations

from math import prod
from typing import Dict, List, Tuple

import torch


SMALL = 0.02  # the spread of biases, offsets, positions and gains about 1


def _linear(d_in: int, d_out: int, bias: bool = True):
    leaf = {"w": ("normal", (d_in, d_out), d_in ** -0.5)}
    if bias:
        leaf["b"] = ("normal", (d_out,), SMALL)
    return leaf


def _ln(d: int):
    return {"g": ("gain", (d,), SMALL), "b": ("normal", (d,), SMALL)}


def _attn(d: int):
    return {"query": _linear(d, d), "key": _linear(d, d, bias=False),
            "value": _linear(d, d), "out": _linear(d, d)}


def _block(d: int, ffn: int, cross: bool):
    block = {"attn_ln": _ln(d), "attn": _attn(d), "mlp_ln": _ln(d),
             "mlp1": _linear(d, ffn), "mlp2": _linear(ffn, d)}
    if cross:
        block["cross_attn_ln"] = _ln(d)
        block["cross_attn"] = _attn(d)
    return block


def layout(dims: Dict[str, int]):
    """The tree of (kind, shape, std) leaves for a configuration's sizes
    (``registry.dims``); a "gain" leaf is 1 + std * N(0, 1)."""
    d, n_mels = dims["d_model"], dims["n_mels"]
    return {
        "encoder": {
            "conv1": {"w": ("normal", (3, n_mels, d), (3 * n_mels) ** -0.5),
                      "b": ("normal", (d,), SMALL)},
            "conv2": {"w": ("normal", (3, d, d), (3 * d) ** -0.5),
                      "b": ("normal", (d,), SMALL)},
            "blocks": [_block(d, dims["encoder_ffn"], False)
                       for _ in range(dims["encoder_layers"])],
            "ln_post": _ln(d),
        },
        "decoder": {
            "token_embedding": ("normal", (dims["n_vocab"], d), 0.02),
            "positional_embedding": ("normal", (dims["n_text_ctx"], d), SMALL),
            "blocks": [_block(d, dims["decoder_ffn"], True)
                       for _ in range(dims["decoder_layers"])],
            "ln": _ln(d),
        },
    }


def leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """[(dotted name, leaf)] in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}.{i}" if prefix else str(i))]
    return [(prefix, tree)]


def _build(tree, make):
    if isinstance(tree, dict):
        return {k: _build(v, make) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, make) for v in tree]
    return make(tree)


def make_params(dims: Dict[str, int], seed: int, device) -> Dict:
    """Float32 weights on ``device`` from ``seed``."""
    spec = layout(dims)
    total = sum(prod(shape) for _, (_, shape, _) in leaves(spec))
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    offset = 0

    def make(leaf):
        nonlocal offset
        kind, shape, std = leaf
        n = prod(shape)
        t = draw[offset:offset + n].view(shape).mul_(std)
        offset += n
        if kind == "gain":
            t.add_(1.0)
        return t

    with torch.no_grad():
        return _build(spec, make)
