"""Parameter-tree inspection utilities.

The PyTorch package's copy of ``whisper_ipa_tpu/utils/trees.py``, over this
package's trees: nested dicts, lists and tuples whose leaves are tensors,
arrays or scalars (``None`` is an empty subtree, as in a pytree).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def tree_leaves(tree) -> List:
    """The leaves of a nested dict/list/tuple, in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.asarray(leaf).dtype.itemsize


def tree_count(tree) -> int:
    """Total number of scalar elements in a tree."""
    return sum(int(np.prod(tuple(np.shape(x)))) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across leaves (by dtype itemsize)."""
    return sum(int(np.prod(tuple(np.shape(x)))) * _itemsize(x)
               for x in tree_leaves(tree))


def tree_summary(tree, max_depth: int = 2) -> Dict[str, int]:
    """Per-subtree element counts down to max_depth (debugging aid)."""
    out: Dict[str, int] = {}

    def walk(node, prefix, depth):
        if depth >= max_depth or not isinstance(node, dict):
            out[prefix or "/"] = tree_count(node)
            return
        for key, value in node.items():
            walk(value, f"{prefix}.{key}" if prefix else key, depth + 1)

    walk(tree, "", 0)
    return out
