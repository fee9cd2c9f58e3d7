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
``safetensors_io``; HF-transformers names load too. The inference CLIs
load a checkpoint over base weights with ``load_checkpoint_auto``: the
decoder-only overlay of the reference contract, or every tensor for a full
fine-tune, as the run's ``training_config.json`` says.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

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


def _overlay(base_params: Params,
             canon: Mapping[str, torch.Tensor]) -> Tuple[Params, int]:
    """Overwrite the base tree's tensors with the canonical checkpoint
    tensors of the same names, as f32 on the base tensor's device; returns
    (params, number overlaid). A shape mismatch raises."""
    base_flat = flatten_params(base_params)
    n_loaded = 0
    for k, v in canon.items():
        if k in base_flat:
            expected = base_flat[k]
            v = torch.as_tensor(v)
            if tuple(v.shape) != tuple(expected.shape):
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint {tuple(v.shape)} vs "
                    f"model {tuple(expected.shape)}"
                )
            base_flat[k] = v.to(device=expected.device,
                                dtype=torch.float32).contiguous()
            n_loaded += 1
    return unflatten_params(base_flat), n_loaded


def overlay_decoder_weights(
    base_params: Params, checkpoint_flat: Mapping[str, torch.Tensor]
) -> Tuple[Params, int]:
    """The decoder-overlay load: overwrite decoder.* onto base params.

    Returns (params, number of overlaid tensors), the reference's
    decoder-only contract (its scripts/evaluate_model.py:56-73).
    """
    fmt = detect_format(checkpoint_flat)
    decoder_only = {
        k: v for k, v in checkpoint_flat.items()
        if "decoder" in k.split(".")[0:2]
    }
    canon = (_hf_to_canonical(decoder_only) if fmt == "hf"
             else _mlx_to_canonical(decoder_only))
    canon = {k: v for k, v in canon.items() if k.startswith("decoder.")}
    return _overlay(base_params, canon)


def checkpoint_overlay_mode(checkpoint_path: str) -> Optional[bool]:
    """Whether a checkpoint needs the full overlay (a trained encoder),
    from its run's training_config.json.

    ``checkpoint-N`` / ``best-checkpoint`` directories sit inside the run
    directory that holds ``training_config.json``; a run recorded with
    ``freeze_encoder: false`` trained its encoder. Returns True (full),
    False (decoder-only), or None (no metadata: the caller decides, and
    checkpoints of the reference pipeline keep its decoder-only contract).
    """
    d = checkpoint_path
    if not os.path.isdir(d):
        d = os.path.dirname(d)
    for cand in (d, os.path.dirname(d)):
        cfg_path = os.path.join(cand, "training_config.json")
        if os.path.isfile(cfg_path):
            try:
                with open(cfg_path) as f:
                    fe = json.load(f)["training_args"].get("freeze_encoder")
            except (OSError, ValueError, KeyError, AttributeError, TypeError):
                return None
            if fe is None:
                return None
            return not fe
    return None


def load_checkpoint_auto(
    checkpoint_path: str, base_params: Params, full: Optional[bool] = None
) -> Tuple[Params, int]:
    """``load_checkpoint_model`` with the overlay mode read from the run.

    full=None reads the run's training_config.json
    (``checkpoint_overlay_mode``): full fine-tunes get the full overlay,
    everything else the decoder-only contract. True/False override it (the
    CLIs' --full-checkpoint / --decoder-only).
    """
    if full is None:
        full = checkpoint_overlay_mode(checkpoint_path)
        if full:
            # stderr: a CLI's stdout stays its report
            print(
                "(auto) full overlay: checkpoint run recorded "
                "freeze_encoder=false, so its encoder is trained",
                file=sys.stderr,
            )
        full = bool(full)
    return load_checkpoint_model(checkpoint_path, base_params, full=full)


_vocab_mismatch_warned = False


def _guard_vocab_provenance(checkpoint_dir: str) -> None:
    """Refuse to decode a checkpoint through a different vocabulary.

    Every inference entry point loads weights through
    ``load_checkpoint_model``, so a checkpoint trained with byte-fallback
    ranks meeting real tiktoken ranks (or the reverse) is caught here: the
    text-token ids differ though the special tokens line up. Unstamped
    checkpoints pass. WHISPER_IPA_TPU_ALLOW_VOCAB_MISMATCH=1 turns the
    error into one warning a process.
    """
    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    if not os.path.isfile(meta_path):
        return
    try:
        with open(meta_path) as f:
            stamped = json.load(f).get("vocab_provenance")
    except (OSError, ValueError, AttributeError):
        return
    if stamped is None:
        return
    from ..tokenizer import get_tokenizer

    current = getattr(get_tokenizer(multilingual=True), "provenance", None)
    if current is None or stamped == current:
        return
    msg = (
        f"checkpoint {checkpoint_dir} was trained with vocabulary "
        f"{stamped!r} but the active tokenizer is {current!r}; text "
        "token ids are incompatible and decoded output would be "
        "garbage. Point WHISPER_IPA_TPU_TIKTOKEN at the matching rank "
        "file, or set WHISPER_IPA_TPU_ALLOW_VOCAB_MISMATCH=1 to "
        "override."
    )
    if os.environ.get("WHISPER_IPA_TPU_ALLOW_VOCAB_MISMATCH") == "1":
        global _vocab_mismatch_warned
        if not _vocab_mismatch_warned:
            print(f"WARNING: {msg}", file=sys.stderr)
            _vocab_mismatch_warned = True
        return
    raise ValueError(msg)


def load_checkpoint_model(
    checkpoint_path: str, base_params: Params, full: bool = False
) -> Tuple[Params, int]:
    """Load ``<dir>/model.safetensors`` (or a .safetensors path) over
    ``base_params``: the decoder's tensors, or with full=True every
    matching tensor (a full fine-tune's trained encoder too). The result
    stays on the base tensors' devices, in f32."""
    weights_path = checkpoint_path
    if os.path.isdir(checkpoint_path):
        weights_path = os.path.join(checkpoint_path, "model.safetensors")
    _guard_vocab_provenance(os.path.dirname(os.path.abspath(weights_path)))
    flat = load_safetensors_flat(weights_path)
    if not full:
        return overlay_decoder_weights(base_params, flat)
    if detect_format(flat) == "hf":
        return _overlay(base_params, _hf_to_canonical(flat))
    return _overlay(base_params, _mlx_to_canonical(flat))


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
