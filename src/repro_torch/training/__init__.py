"""repro_torch.training — the optimizer, the local and the sharded train
steps, int8 gradient compression and checkpointing (counterpart of
``repro.training``)."""

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import ef_int8_allreduce, init_error_state
from repro_torch.training.optimizer import (
    Hyper,
    adamw_init,
    adamw_update,
    lr_schedule,
    opt_state_specs,
)
from repro_torch.training.step import (
    apply_fsdp,
    build_train_step,
    gather_train_state,
    make_sharded_train_step,
    place_train_state,
    sharded_adamw_init,
    train_state_specs,
    train_state_template,
)

__all__ = ["Hyper", "adamw_init", "adamw_update", "lr_schedule", "opt_state_specs",
           "build_train_step", "make_sharded_train_step", "apply_fsdp", "sharded_adamw_init",
           "gather_train_state", "place_train_state", "train_state_specs", "train_state_template",
           "ef_int8_allreduce", "init_error_state", "CheckpointManager"]
