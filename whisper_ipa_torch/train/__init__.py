"""Single-device fine-tuning: loss, optimizer, step, checkpoints, loop."""

from .checkpoints import (
    check_vocab_provenance,
    latest_checkpoint,
    restore_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
)
from .loop import train, validate
from .loss import compute_loss, eot_loss_mask, masked_cross_entropy
from .optimizer import Optimizer, OptState, make_schedule
from .step import TrainState, create_train_state, train_step

__all__ = [
    "OptState",
    "Optimizer",
    "TrainState",
    "check_vocab_provenance",
    "compute_loss",
    "create_train_state",
    "eot_loss_mask",
    "latest_checkpoint",
    "make_schedule",
    "masked_cross_entropy",
    "restore_checkpoint",
    "save_best_checkpoint",
    "save_checkpoint",
    "train",
    "train_step",
    "validate",
]
