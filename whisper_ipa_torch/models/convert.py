"""Numpy bridge between the port's parameter tree and the canonical names.

The canonical flat names are those of
``whisper_ipa_tpu/models/convert.flatten_params`` (``encoder.conv1.w``,
``decoder.blocks.0.attn.query.b``, ...), with the reference's layouts:
(in, out) linear weights and (width, in, out) conv kernels. A tree from
either package passes through ``{name: np.ndarray}`` unchanged, which is
how the tests hand the JAX package's weights to the port.

Loading trained checkpoints (the reference's safetensors and MLX names,
decoder overlay) is not ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

Params = Dict[str, Any]


def flatten_params(tree, prefix: str = "") -> Dict[str, Any]:
    """Flatten the nested dict/list tree into {dot.name: leaf}."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_params(v, f"{prefix}.{i}" if prefix else str(i)))
    elif prefix:
        flat[prefix] = tree
    return flat


def unflatten_params(flat: Mapping[str, Any]) -> Params:
    """Invert flatten_params; numeric components become list indices."""
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            if node and all(re.fullmatch(r"\d+", k) for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def params_from_numpy(
    flat: Mapping[str, np.ndarray], device: Optional[torch.device] = None
) -> Params:
    """{canonical name: array} -> the port's tree of tensors on ``device``.

    Arrays are copied, so the tree owns its memory."""
    return unflatten_params(
        {
            name: torch.from_numpy(np.array(arr, copy=True)).to(device)
            for name, arr in flat.items()
        }
    )


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The port's tree -> {canonical name: array} on the host."""
    return {
        name: t.detach().cpu().numpy()
        for name, t in flatten_params(params).items()
    }


def params_to(params: Params, device) -> Params:
    """The same tree with every tensor moved to ``device``."""
    return unflatten_params(
        {name: t.to(device) for name, t in flatten_params(params).items()}
    )
