"""TrainState and the training step.

Counterpart of ``whisper_ipa_tpu/train/step.py`` (``TrainState``,
``create_train_state``, ``train_step``). The reference compiles one XLA
program per step and donates the state's buffers; here the step runs
eagerly: forward, ``torch.autograd.grad`` over the trainable tensors, then
the optimizer updates the parameters and moments in place (the returned
state is the same object, updated). Every float32 product in the step runs
at full fp32 on the card (``full_fp32``), as in the reference.

Not ported yet: ``train_chunk`` (several steps per device call), the
ZeRO-1 and mesh steps (multi-device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models.convert import flatten_params
from ..ops.precision import full_fp32
from .loss import compute_loss
from .optimizer import Optimizer, OptState, Schedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    step: int
    params: Dict[str, Any]
    opt_state: OptState


def create_train_state(
    params,
    learning_rate: float = 1e-5,
    max_grad_norm: float = 1.0,
    freeze_encoder: bool = True,
    schedule: Optional[Schedule] = None,
    accum_steps: int = 1,
    mu_dtype: Optional[str] = None,
) -> Tuple[TrainState, Optimizer]:
    """(state at step 0, the optimizer). ``schedule`` (a float or a
    function of the step count) replaces ``learning_rate`` when given;
    ``mu_dtype`` is None or "bfloat16"."""
    tx = Optimizer(
        learning_rate=schedule if schedule is not None else learning_rate,
        max_grad_norm=max_grad_norm,
        freeze_encoder=freeze_encoder,
        accum_steps=accum_steps,
        mu_dtype=_DTYPES[mu_dtype] if mu_dtype else None,
    )
    state = TrainState(
        step=0, params=params, opt_state=tx.init(flatten_params(params))
    )
    return state, tx


def train_step(
    state: TrainState,
    mel,
    tokens,
    cfg: WhisperConfig,
    tx: Optimizer,
    eot: int,
    freeze_encoder: bool = True,
    dtype_name: str = "float32",
    remat: bool = False,
    blockwise: bool = False,
    inputs_are_features: bool = False,
    bf16_head: bool = False,
) -> Tuple[TrainState, torch.Tensor]:
    """One optimization step. Returns (state, loss as a 0-d tensor on the
    device; read it with ``float()`` only when it is needed).

    dtype_name: activation dtype, "float32" or "bfloat16" (parameters,
    optimizer state and the logits head stay float32). inputs_are_features:
    ``mel`` holds precomputed encoder outputs (B, n_audio_ctx, d).
    """
    flat = flatten_params(state.params)
    names = [n for n in flat if tx.trainable(n)]
    leaves = [flat[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with full_fp32():
            loss = compute_loss(
                state.params,
                cfg,
                None if inputs_are_features else mel,
                tokens,
                eot,
                audio_features=mel if inputs_are_features else None,
                freeze_encoder=freeze_encoder,
                dtype=_DTYPES[dtype_name],
                remat=remat,
                blockwise=blockwise,
                bf16_head=bf16_head,
            )
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = {
        n: torch.zeros_like(t) if g is None else g
        for n, t, g in zip(names, leaves, grads)
    }
    tx.step(flat, grads, state.opt_state)
    state.step += 1
    return state, loss.detach()
