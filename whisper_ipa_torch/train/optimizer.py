"""Per-tensor gradient clipping + AdamW with optax's numerics.

Counterpart of ``whisper_ipa_tpu/train/optimizer.py``, which chains
``clip_by_per_tensor_norm`` and ``optax.adamw`` (b1 0.9, b2 0.999, eps
1e-8, weight decay 0.01), masks the encoder out when it is frozen, and
wraps the chain in ``optax.MultiSteps`` for gradient accumulation. Written
here as plain functions over the flat {canonical name: tensor} view of the
parameter tree, in optax's order of operations, because
``torch.optim.AdamW`` places eps and the decay differently:

  g   <- g * min(max_norm / (||g|| + 1e-6), 1)          per tensor
  mu  <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu
  u   <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
  p   <- p - lr(s) * u

with t the update count from 1 and s the schedule's count from 0.
``max_grad_norm=None`` drops the clip and ``weight_decay=0`` the decay,
which is ``optax.adam`` (the Medusa heads' optimizer). A
frozen encoder gets no optimizer state and no update. ``mu_dtype`` stores
the first moment in that dtype (the update is computed before the cast).
With ``accum_steps`` k > 1, gradients are averaged over k calls (Welford
mean, as ``MultiSteps``) and the update runs on every k-th call only.

A step reads nothing back from the device and copies nothing to it: the
host's scalars (b1, b2, the scheduled rate) enter as fill kernels
(``_scalar``), so ``train.step.train_chunk`` runs C steps without a sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8

Schedule = Union[float, Callable[[int], float]]


def make_schedule(
    learning_rate: float,
    warmup_steps: int = 0,
    decay: str = "constant",
    total_steps: int = 10000,
) -> Schedule:
    """LR schedule: linear warmup + {constant, linear, cosine} decay.

    Returns the learning rate itself when there is nothing to schedule,
    else a function of the step count, evaluated in float32 as optax's
    schedules are.
    """
    if warmup_steps <= 0 and decay == "constant":
        return learning_rate
    f32 = np.float32
    if decay == "constant":
        def after(count):
            return f32(learning_rate)
    elif decay == "linear":
        steps = max(total_steps - warmup_steps, 1)
        after = _linear(learning_rate, 0.0, steps)
    elif decay == "cosine":
        steps = float(max(total_steps - warmup_steps, 1))

        def after(count):
            c = np.minimum(f32(count), f32(steps))
            cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps)))
            return f32(learning_rate) * ((f32(1) - f32(0)) * cosine + f32(0))
    else:
        raise ValueError(f"unknown decay: {decay!r}")
    if warmup_steps <= 0:
        return lambda count: float(after(count))
    warmup = _linear(0.0, learning_rate, warmup_steps)
    return lambda count: float(
        warmup(count) if count < warmup_steps else after(count - warmup_steps)
    )


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule(init, end, steps) in float32."""
    f32 = np.float32

    def schedule(count):
        c = np.clip(np.int32(count), 0, steps)
        frac = f32(1) - f32(c) / f32(steps)
        return (f32(init) - f32(end)) * frac + f32(end)

    return schedule


def _scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` rounded to ``dtype`` in a 0-d tensor on ``device``, made by
    a fill kernel: ``torch.tensor(value, device=cuda)`` copies from the
    host and waits for the stream."""
    return torch.full((), value, dtype=dtype, device=device)


@dataclass
class OptState:
    """Optimizer state over the trainable tensors (flat canonical names).

    count: AdamW updates so far; schedule_count: the schedule's own count
    (None without a schedule); mini_step / gradient_step / acc_grads: the
    accumulation state (acc_grads empty when accum_steps == 1).
    """

    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    schedule_count: Optional[int] = None
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class Optimizer:
    """Per-tensor clip + AdamW (+ optional gradient accumulation)."""

    learning_rate: Schedule = 1e-5
    max_grad_norm: Optional[float] = 1.0  # None: no clip (optax.adam)
    weight_decay: float = 0.01
    freeze_encoder: bool = True
    accum_steps: int = 1
    mu_dtype: Optional[torch.dtype] = None

    @property
    def scheduled(self) -> bool:
        return callable(self.learning_rate)

    def trainable(self, name: str) -> bool:
        return not (self.freeze_encoder and name.startswith("encoder."))

    def init(self, flat_params: Dict[str, torch.Tensor]) -> OptState:
        names = [n for n in flat_params if self.trainable(n)]
        return OptState(
            count=0,
            mu={n: torch.zeros_like(flat_params[n], dtype=self.mu_dtype)
                for n in names},
            nu={n: torch.zeros_like(flat_params[n]) for n in names},
            schedule_count=0 if self.scheduled else None,
            acc_grads=(
                {n: torch.zeros_like(flat_params[n]) for n in names}
                if self.accum_steps > 1 else {}
            ),
        )

    def lr_at(self, count: int) -> float:
        return (
            self.learning_rate(count) if self.scheduled
            else self.learning_rate
        )

    @torch.no_grad()
    def step(self, flat_params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: OptState,
             reduce_sq: Optional[Callable] = None) -> bool:
        """Apply one call's gradients: update ``state`` and, on an update
        call, the trainable tensors of ``flat_params`` in place. Returns
        whether this call updated them.

        reduce_sq: for sharded tensors, a function from {name: the local
        block's sum of squared gradients} to the whole tensor's (the
        clip's norm is the whole tensor's, ``train/step.py``)."""
        if self.accum_steps > 1:
            n = state.mini_step
            for name, g in grads.items():
                acc = state.acc_grads[name]
                acc.copy_(acc + (g - acc) / float(n + 1))
            state.mini_step = (n + 1) % self.accum_steps
            if n != self.accum_steps - 1:
                return False
            grads = {k: v.clone() for k, v in state.acc_grads.items()}
            for acc in state.acc_grads.values():
                acc.zero_()
            state.gradient_step += 1
        self._adamw(flat_params, grads, state, reduce_sq)
        return True

    def _adamw(self, flat_params, grads, state: OptState,
               reduce_sq: Optional[Callable] = None) -> None:
        count = state.count + 1
        device = next(iter(grads.values())).device
        f32 = dict(dtype=torch.float32, device=device)
        bc1 = 1 - _scalar(B1, **f32) ** count
        bc2 = 1 - _scalar(B2, **f32) ** count
        if self.scheduled:
            lr = _scalar(self.learning_rate(state.schedule_count), **f32)
            state.schedule_count += 1
        else:
            lr = self.learning_rate
        if self.max_grad_norm is not None:
            sq = {name: (g * g).sum() for name, g in grads.items()}
            if reduce_sq is not None:
                sq = reduce_sq(sq)
        b1 = {}  # b1 in each moment dtype and device
        for name, g in grads.items():
            p = flat_params[name]
            if self.max_grad_norm is not None:
                norm = torch.sqrt(sq[name])
                g = g * torch.clamp_max(self.max_grad_norm / (norm + 1e-6), 1.0)
            # b1 * mu in the moment's dtype, b1 rounded to it too (a bf16
            # moment decays by bf16(0.9) = 0.8984375), as optax does
            m = state.mu[name]
            key = (m.dtype, m.device)
            if key not in b1:
                b1[key] = _scalar(B1, m.dtype, m.device)
            mu = (1 - B1) * g + b1[key] * m
            nu = (1 - B2) * (g * g) + B2 * state.nu[name]
            u = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + EPS
            )
            u = u + self.weight_decay * p
            p.add_(-lr * u)
            state.mu[name] = mu.to(state.mu[name].dtype)
            state.nu[name] = nu
        state.count = count
