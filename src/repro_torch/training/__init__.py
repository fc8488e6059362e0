"""repro_torch.training — the optimizer, the local train step and
checkpointing (counterpart of ``repro.training`` on one device)."""

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import Hyper, adamw_init, adamw_update, lr_schedule
from repro_torch.training.step import build_train_step

__all__ = ["Hyper", "adamw_init", "adamw_update", "lr_schedule", "build_train_step",
           "CheckpointManager"]
