"""Fine-tuning: loss, optimizer, step (one device or a mesh), checkpoints,
loop."""

from .checkpoints import (
    check_vocab_provenance,
    latest_checkpoint,
    restore_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
)
from .logger import (
    TrainingLogger,
    console_step_line,
    get_hardware_info,
    save_training_config,
)
from .loop import train, validate
from .loss import compute_loss, eot_loss_mask, masked_cross_entropy
from .optimizer import Optimizer, OptState, make_schedule
from .step import (
    TrainState,
    create_train_state,
    create_train_state_zero1,
    make_zero1_step,
    train_chunk,
    train_step,
)

__all__ = [
    "OptState",
    "Optimizer",
    "TrainState",
    "TrainingLogger",
    "check_vocab_provenance",
    "compute_loss",
    "console_step_line",
    "create_train_state",
    "create_train_state_zero1",
    "eot_loss_mask",
    "get_hardware_info",
    "latest_checkpoint",
    "make_schedule",
    "make_zero1_step",
    "masked_cross_entropy",
    "restore_checkpoint",
    "save_best_checkpoint",
    "save_checkpoint",
    "save_training_config",
    "train",
    "train_chunk",
    "train_step",
    "validate",
]
