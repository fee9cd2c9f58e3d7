"""Parameter-tree flattening, the numpy bridge, and checkpoint interop.

The canonical flat names are those of
``whisper_ipa_tpu/models/convert.flatten_params`` (``encoder.conv1.w``,
``decoder.blocks.0.attn.query.b``, ...), with the reference's layouts:
(in, out) linear weights and (width, in, out) conv kernels. A tree from
either package passes through ``{name: np.ndarray}`` unchanged, which is
how the tests hand the JAX package's weights to the port.

Checkpoints are the reference's contract, kept bit for bit: a single
``model.safetensors`` with MLX module names and layouts ((out, in) linear,
(out, width, in) conv), written and read by the in-tree
``safetensors_io``; HF-transformers names load too. The decoder-overlay
loaders of the inference CLIs are not ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import safetensors_io

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


# -- MLX / HF name mapping (the checkpoint half of the reference module) ----

_CANON_TO_MLX_LEAF = {"w": "weight", "b": "bias", "g": "weight"}


def _canonical_to_mlx_name(name: str) -> str:
    parts = name.split(".")
    if name == "decoder.positional_embedding":
        return name
    if parts[-1] == "token_embedding":
        return name + ".weight"
    return ".".join(parts[:-1] + [_CANON_TO_MLX_LEAF.get(parts[-1], parts[-1])])


def to_mlx_flat(params: Params) -> Dict[str, torch.Tensor]:
    """Canonical tree -> {mlx_name: CPU tensor} with MLX tensor layouts."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in flatten_params(params).items():
        t = torch.as_tensor(t).detach().cpu()
        if name.endswith(".w"):
            if t.dim() == 2:
                t = t.T  # (in, out) -> (out, in)
            elif t.dim() == 3:
                t = t.permute(2, 0, 1)  # (W, I, O) -> (O, W, I)
        out[_canonical_to_mlx_name(name)] = t.contiguous()
    return out


def _mlx_to_canonical(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{mlx_name: tensor} -> {canonical_name: tensor} with canonical layouts."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in flat.items():
        parts = name.split(".")
        if name == "decoder.positional_embedding":
            out[name] = t
            continue
        if parts[-2:] == ["token_embedding", "weight"]:
            out[".".join(parts[:-1])] = t
            continue
        leaf, head = parts[-1], parts[:-1]
        is_ln = head and (
            head[-1].endswith("_ln") or head[-1] in ("ln", "ln_post")
        )
        if leaf == "weight":
            if is_ln:
                out[".".join(head + ["g"])] = t
            elif t.dim() == 3:
                out[".".join(head + ["w"])] = t.permute(1, 2, 0)
            else:
                out[".".join(head + ["w"])] = t.T
        elif leaf == "bias":
            out[".".join(head + ["b"])] = t
        else:
            out[name] = t
    return out


_HF_ATTN = {"q_proj": "query", "k_proj": "key", "v_proj": "value",
            "out_proj": "out"}


def _hf_to_canonical(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF transformers Whisper names -> canonical names/layouts."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in flat.items():
        n = name[len("model."):] if name.startswith("model.") else name
        if n in ("proj_out.weight", "encoder.embed_positions.weight"):
            continue  # tied to embed_tokens / fixed sinusoids
        n = n.replace("decoder.embed_tokens.weight", "decoder.token_embedding")
        n = n.replace(
            "decoder.embed_positions.weight", "decoder.positional_embedding"
        )
        parts = n.split(".")
        if len(parts) >= 2 and parts[1] == "layers":
            base = [parts[0], "blocks", parts[2]]
            rest = parts[3:]
            if rest[0] in ("self_attn", "encoder_attn"):
                group = "attn" if rest[0] == "self_attn" else "cross_attn"
                leaf = "w" if rest[2] == "weight" else "b"
                out[".".join(base + [group, _HF_ATTN[rest[1]], leaf])] = (
                    t.T if leaf == "w" else t
                )
            elif rest[0] in ("self_attn_layer_norm", "encoder_attn_layer_norm"):
                group = (
                    "attn_ln" if rest[0] == "self_attn_layer_norm"
                    else "cross_attn_ln"
                )
                leaf = "g" if rest[1] == "weight" else "b"
                out[".".join(base + [group, leaf])] = t
            elif rest[0] in ("fc1", "fc2"):
                mlp = "mlp1" if rest[0] == "fc1" else "mlp2"
                leaf = "w" if rest[1] == "weight" else "b"
                out[".".join(base + [mlp, leaf])] = t.T if leaf == "w" else t
            elif rest[0] == "final_layer_norm":
                leaf = "g" if rest[1] == "weight" else "b"
                out[".".join(base + ["mlp_ln", leaf])] = t
            continue
        if parts[0] in ("encoder", "decoder") and len(parts) >= 2:
            if parts[1] in ("conv1", "conv2"):
                leaf = "w" if parts[2] == "weight" else "b"
                out[".".join([parts[0], parts[1], leaf])] = (
                    t.permute(2, 1, 0) if leaf == "w" else t
                )
                continue
            if parts[1] == "layer_norm":
                tgt = "ln_post" if parts[0] == "encoder" else "ln"
                leaf = "g" if parts[2] == "weight" else "b"
                out[".".join([parts[0], tgt, leaf])] = t
                continue
        out[n] = t
    return out


def detect_format(flat: Mapping[str, object]) -> str:
    """"hf" for HF-transformers names, else "mlx"."""
    keys = flat.keys()
    if any(k.startswith(("model.", "proj_out")) for k in keys):
        return "hf"
    if any(k.startswith(("encoder.layers.", "decoder.layers.")) for k in keys):
        return "hf"
    return "mlx"


def params_from_flat(flat: Mapping[str, object], fmt: Optional[str] = None,
                     device=None) -> Params:
    """Canonical float32 tree from a foreign flat dict (format detected
    unless given: "hf", "mlx", or anything else for canonical names)."""
    flat = {k: torch.as_tensor(v) for k, v in flat.items()}
    fmt = fmt or detect_format(flat)
    if fmt == "hf":
        canon = _hf_to_canonical(flat)
    elif fmt == "mlx":
        canon = _mlx_to_canonical(flat)
    else:
        canon = dict(flat)
    return unflatten_params(
        {
            k: v.to(device=device, dtype=torch.float32).contiguous().clone()
            for k, v in canon.items()
        }
    )


def save_safetensors(path: str, params: Params) -> None:
    """Save a canonical tree as MLX-named safetensors (reference format)."""
    safetensors_io.save_file(to_mlx_flat(params), path)


def load_safetensors_flat(path: str) -> Dict[str, torch.Tensor]:
    return safetensors_io.load_file(path)


def cast_tree_dtype(tree, dtype):
    """Every floating tensor of a parameter subtree cast to ``dtype`` (e.g.
    a frozen encoder stored in bfloat16)."""
    if isinstance(tree, dict):
        return {k: cast_tree_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree_dtype(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
