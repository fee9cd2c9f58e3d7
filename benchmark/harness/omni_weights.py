"""Seeded random weights for the audio language model, drawn per tensor.

Each tensor is drawn on the device from its own ``torch.Generator``,
seeded with (the run's seed, the tensor's dotted name), so that any part
of the tree can be drawn again alone: the program's whole tree in set-up,
one layer at a time in the check. The tree is the program's
(``whisper_ipa_torch.models.audio_llm``): the tower in Whisper's encoder
layout and scales, as ``weights.layout`` gives them, in float32; the
language model drawn in float32 and stored in bfloat16, the routers in
float32. Scales: linear weights N(0, in^-0.5), the router too (its logits
then about N(0, 1)), biases N(0, 0.02), RMSNorm gains 1 + N(0, 0.02),
the embedding N(0, 0.02).
"""

from __future__ import annotations

import zlib
from typing import Dict

import torch

from benchmark.harness import weights

SMALL = weights.SMALL


def _lin(d_in: int, d_out: int, bias: bool = True):
    leaf = {"w": ("normal", (d_in, d_out), d_in ** -0.5)}
    if bias:
        leaf["b"] = ("normal", (d_out,), SMALL)
    return leaf


def _layer(c: Dict):
    D, H, Hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    Dh = D // H
    F, Fs = c["dynamic_intermediate_size"], c["shared_intermediate_size"]
    E, S = c["mlp_dynamic_expert_num"], c["mlp_fixed_expert_num"]
    slots = E + c["mlp_dynamic_null_expert_num"]
    return {
        "attn_norm": ("gain", (D,), SMALL),
        "q": _lin(D, H * Dh), "k": _lin(D, Hkv * Dh), "v": _lin(D, Hkv * Dh),
        "o": _lin(H * Dh, D, bias=False),
        "mlp_norm": ("gain", (D,), SMALL),
        "router": ("normal", (D, slots), D ** -0.5),
        "shared_w1": ("normal", (S, D, 2 * Fs), D ** -0.5),
        "shared_w2": ("normal", (S, Fs, D), Fs ** -0.5),
        "experts_w1": ("normal", (E, D, 2 * F), D ** -0.5),
        "experts_w2": ("normal", (E, F, D), F ** -0.5),
    }


def part_layout(c: Dict, dims: Dict[str, int], name: str):
    """The leaves of one part of the tree: ``tower``, ``connector``,
    ``embed``, ``layers.<l>``, ``norm`` or ``head``."""
    D, V = c["hidden_size"], c["vocab_size"]
    if name == "tower":
        return {"encoder": weights.layout(dims)["encoder"]}
    if name == "connector":
        return _lin(c["whisper_hidden_size"], D)
    if name == "embed":
        return ("normal", (V, D), SMALL)
    if name.startswith("layers."):
        return _layer(c)
    if name == "norm":
        return ("gain", (D,), SMALL)
    if name == "head":
        return ("normal", (D, V), D ** -0.5)
    raise KeyError(name)


def _seed(seed: int, name: str) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(name.encode())) % (1 << 63)


def _stored(name: str, tower: bool):
    if tower or name.endswith("router"):
        return torch.float32
    return torch.bfloat16


def draw_part(c: Dict, dims: Dict[str, int], seed: int, device, name: str,
              as_float: bool = False):
    """One part (``part_layout``) as the program stores it (or, with
    ``as_float``, those same values in float32)."""
    tower = name == "tower"

    def make(tree, path):
        if isinstance(tree, dict):
            return {k: make(v, f"{path}.{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [make(v, f"{path}.{i}") for i, v in enumerate(tree)]
        kind, shape, std = tree
        gen = torch.Generator(device=device).manual_seed(_seed(seed, path))
        t = torch.randn(shape, generator=gen, device=device).mul_(std)
        if kind == "gain":
            t.add_(1.0)
        t = t.to(_stored(path, tower))
        return t.float() if as_float else t

    with torch.no_grad():
        return make(part_layout(c, dims, name), name)


def make_params(c: Dict, dims: Dict[str, int], seed: int, device) -> Dict:
    """The program's whole tree."""
    tree = {name: draw_part(c, dims, seed, device, name)
            for name in ("tower", "connector", "embed", "norm", "head")}
    tree["layers"] = [draw_part(c, dims, seed, device, f"layers.{l}")
                      for l in range(c["num_hidden_layers"])]
    return tree
