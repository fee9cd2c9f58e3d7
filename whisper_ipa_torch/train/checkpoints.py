"""Checkpoints: reference-compatible weights + full train-state resume.

Counterpart of ``whisper_ipa_tpu/train/checkpoints.py``, writing the same
files, so a checkpoint written by either package resumes in the other:

  checkpoint-{step}/model.safetensors     weights, MLX names and layouts
  checkpoint-{step}/training_state.json   step, loss, metadata
  checkpoint-{step}/opt_state.safetensors the optimizer state under the
                                          key paths the reference's optax
                                          state flattens to, plus __step__

The reference writes its optax state with ``jax.tree_util.keystr`` key
paths; ``_opt_keys`` rebuilds them from the layout: the AdamW state sits
at ``[1][0]`` of the clip + AdamW chain (``[1][2]`` holds the schedule's
count), under ``.inner_states['train'].inner_state`` when the encoder is
frozen (``optax.multi_transform``; the frozen encoder has no moments), and
under ``.inner_opt_state`` beside ``.mini_step``, ``.gradient_step`` and
``.acc_grads`` with gradient accumulation (``optax.MultiSteps``). A file
whose keys do not match this run's layout raises. Orbax checkpoints are
not ported.

A sharded state (``state.layout``: TP blocks, ZeRO-1 moment slices, FSDP
parameter slices) saves the same files one rank would: every rank joins
the all-gathers of its blocks, rank 0 writes, and the others wait on a
barrier. Restore reads the file on the host and moves each rank's block
to its device, so no device holds the whole tree.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import safetensors_io
from ..models.convert import (
    flatten_params,
    load_safetensors_flat,
    params_from_flat,
    save_safetensors,
)
from ..models.convert import unflatten_params
from ..parallel.mesh import place_params
from .optimizer import OptState
from .step import TrainState


def _gathered_params(state: TrainState):
    lay = state.layout
    return unflatten_params({
        n: lay.params[n].gather(t)
        for n, t in flatten_params(state.params).items()
    })


def _gathered(state: TrainState) -> TrainState:
    """The whole state from the ranks' blocks (a collective)."""
    lay, opt = state.layout, state.opt_state

    def table(values, shardings):
        return {n: shardings[n].gather(t) for n, t in values.items()}

    return TrainState(
        step=state.step,
        params=_gathered_params(state),
        opt_state=OptState(
            count=opt.count,
            mu=table(opt.mu, lay.opt.mu),
            nu=table(opt.nu, lay.opt.nu),
            schedule_count=opt.schedule_count,
            mini_step=opt.mini_step,
            gradient_step=opt.gradient_step,
            acc_grads=table(opt.acc_grads, lay.opt.acc_grads),
        ),
    )


def _keypath(name: str) -> str:
    """Canonical dotted name -> the reference's key path string."""
    return "".join(
        f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split(".")
    )


def _opt_keys(state: OptState, param_names) -> Dict[str, Tuple[str, str]]:
    """{checkpoint key: (field, canonical name or "")} for this layout."""
    frozen = not any(n.startswith("encoder.") for n in state.mu)
    accum = bool(state.acc_grads)
    base = (".inner_opt_state" if accum else "") + (
        ".inner_states['train'].inner_state" if frozen else ""
    )
    keys = {f"{base}[1][0].count": ("count", "")}
    for n in state.mu:
        keys[f"{base}[1][0].mu{_keypath(n)}"] = ("mu", n)
        keys[f"{base}[1][0].nu{_keypath(n)}"] = ("nu", n)
    if state.schedule_count is not None:
        keys[f"{base}[1][2].count"] = ("schedule_count", "")
    if accum:
        keys[".mini_step"] = ("mini_step", "")
        keys[".gradient_step"] = ("gradient_step", "")
        for n in param_names:  # every parameter, zeros for a frozen one
            keys[f".acc_grads{_keypath(n)}"] = ("acc_grads", n)
    return keys


def _opt_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    flat_params = flatten_params(state.params)
    opt = state.opt_state
    out: Dict[str, torch.Tensor] = {}
    for key, (fld, name) in _opt_keys(opt, flat_params).items():
        if name:
            table = getattr(opt, fld)
            value = table[name] if name in table else torch.zeros_like(
                flat_params[name], dtype=torch.float32)
        else:
            value = torch.tensor(getattr(opt, fld), dtype=torch.int32)
        out[key] = value
    out["__step__"] = torch.tensor(state.step, dtype=torch.int32)
    return out


def save_checkpoint(
    state: TrainState,
    step: int,
    loss,
    output_dir: str,
    *,
    logger=None,
    start_time: Optional[float] = None,
    learning_rate: Optional[float] = None,
    save_opt_state: bool = True,
    vocab_provenance: Optional[str] = None,
) -> str:
    """Write checkpoint-{step}/ with weights, metadata, and opt state
    (a collective for a sharded state: rank 0 writes)."""
    checkpoint_dir = os.path.join(output_dir, f"checkpoint-{step}")
    if state.layout is not None:
        whole = _gathered(state)
        if dist.get_rank() == 0:
            save_checkpoint(
                whole, step, loss, output_dir, logger=logger,
                start_time=start_time, learning_rate=learning_rate,
                save_opt_state=save_opt_state,
                vocab_provenance=vocab_provenance,
            )
        dist.barrier()
        return checkpoint_dir
    os.makedirs(checkpoint_dir, exist_ok=True)
    save_safetensors(
        os.path.join(checkpoint_dir, "model.safetensors"), state.params
    )
    meta: Dict[str, Any] = {
        "step": step,
        "loss": float(loss) if loss is not None else None,
    }
    if start_time is not None:
        meta["wall_clock_sec"] = time.time() - start_time
    if learning_rate is not None:
        meta["learning_rate"] = learning_rate
    if logger is not None:
        meta["best_pfer"] = (
            logger.best_pfer if logger.best_pfer != float("inf") else None
        )
        meta["best_pfer_step"] = logger.best_pfer_step
        meta["latest_val_per"] = logger.latest_val_per
        meta["latest_val_pfer"] = logger.latest_val_pfer
    if vocab_provenance is not None:
        meta["vocab_provenance"] = vocab_provenance
    meta["timestamp"] = datetime.now().isoformat()
    with open(os.path.join(checkpoint_dir, "training_state.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if save_opt_state:
        safetensors_io.save_file(
            _opt_tensors(state),
            os.path.join(checkpoint_dir, "opt_state.safetensors"),
        )
    return checkpoint_dir


def save_best_checkpoint(
    state: TrainState, step: int, pfer: float, per: float, output_dir: str
) -> str:
    """Overwrite best-checkpoint/ (weights + training_state.json); a
    collective for a sharded state, as ``save_checkpoint``."""
    best_dir = os.path.join(output_dir, "best-checkpoint")
    if state.layout is not None:
        params = _gathered_params(state)
        if dist.get_rank() == 0:
            save_best_checkpoint(TrainState(step, params, state.opt_state),
                                 step, pfer, per, output_dir)
        dist.barrier()
        return best_dir
    if os.path.isdir(best_dir):
        shutil.rmtree(best_dir)
    os.makedirs(best_dir, exist_ok=True)
    save_safetensors(os.path.join(best_dir, "model.safetensors"), state.params)
    with open(os.path.join(best_dir, "training_state.json"), "w") as f:
        json.dump(
            {
                "step": step,
                "pfer": pfer,
                "per": per,
                "timestamp": datetime.now().isoformat(),
            },
            f,
            indent=2,
        )
    return best_dir


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Find the highest-step checkpoint-N directory."""
    if not os.path.isdir(output_dir):
        return None
    best_step = -1
    best_path = None
    for name in os.listdir(output_dir):
        if name.startswith("checkpoint-"):
            try:
                step = int(name.split("-", 1)[1])
            except ValueError:
                continue
            if step > best_step:
                best_step = step
                best_path = os.path.join(output_dir, name)
    return best_path


def restore_checkpoint(
    checkpoint_dir: str, state_template: TrainState
) -> Tuple[TrainState, Dict[str, Any]]:
    """Resume: rebuild the TrainState (params, optimizer state, step) and
    read the metadata. The optimizer layout (frozen encoder, accumulation,
    schedule) is the template's; a file written for another layout raises
    ``ValueError``. A sharded template (``layout``) gets each rank's
    blocks, cut on the host."""
    layout = state_template.layout
    device = flatten_params(state_template.params)[
        "decoder.token_embedding"
    ].device
    params = params_from_flat(
        load_safetensors_flat(
            os.path.join(checkpoint_dir, "model.safetensors")
        ),
        fmt="mlx",
        device="cpu" if layout is not None else device,
    )
    global_shapes = {n: t.shape for n, t in flatten_params(params).items()}
    if layout is not None:
        params = place_params(params, unflatten_params(layout.params))
    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    meta: Dict[str, Any] = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    template = state_template.opt_state
    opt = OptState(
        count=template.count,
        mu=dict(template.mu),
        nu=dict(template.nu),
        schedule_count=template.schedule_count,
        mini_step=template.mini_step,
        gradient_step=template.gradient_step,
        acc_grads=dict(template.acc_grads),
    )
    step = int(meta.get("step", 0))
    opt_path = os.path.join(checkpoint_dir, "opt_state.safetensors")
    if os.path.isfile(opt_path):
        flat_opt = safetensors_io.load_file(opt_path)
        if "__step__" in flat_opt:
            step = int(flat_opt.pop("__step__"))
        keys = _opt_keys(template, flatten_params(params))
        missing = sorted(set(keys) - set(flat_opt))
        if missing:
            raise ValueError(
                f"{opt_path} does not hold this run's optimizer layout "
                f"(frozen encoder, accumulation and schedule must match the "
                f"run that wrote it); missing {missing[0]!r} and "
                f"{len(missing) - 1} more"
            )
        for key, (fld, name) in keys.items():
            saved = flat_opt[key]
            if not name:
                setattr(opt, fld, int(saved))
                continue
            table = getattr(opt, fld)
            if name not in table:
                continue  # a frozen tensor's (zero) accumulator
            like = table[name]
            if layout is not None:
                block = getattr(layout.opt, fld)[name].local_block(
                    saved.reshape(global_shapes[name]))
                table[name] = block.to(device=like.device, dtype=like.dtype)
                continue
            table[name] = saved.reshape(like.shape).to(
                device=like.device, dtype=like.dtype
            )
    return TrainState(step=step, params=params, opt_state=opt,
                      layout=layout), meta


def check_vocab_provenance(
    checkpoint_dir: str, tokenizer, strict: bool = True
) -> Optional[str]:
    """Refuse to mix a checkpoint with a different vocabulary.

    Reads ``vocab_provenance`` from the checkpoint's training_state.json and
    compares it to ``tokenizer.provenance``; returns the checkpoint's
    provenance (None if unstamped).
    """
    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    stamped = meta.get("vocab_provenance")
    if stamped is None:
        return None
    current = getattr(tokenizer, "provenance", None)
    if current is not None and stamped != current:
        msg = (
            f"checkpoint {checkpoint_dir} was trained with vocabulary "
            f"{stamped!r} but the active tokenizer is {current!r}; text "
            "token ids are incompatible. Point WHISPER_IPA_TPU_TIKTOKEN at "
            "the matching rank file (or pass strict=False to override)."
        )
        if strict:
            raise ValueError(msg)
        print(f"Warning: {msg}")
    return stamped
