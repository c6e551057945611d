"""repro_torch.train — optimizers, train step, checkpointing, fault tolerance."""

from repro_torch.train.optimizer import OptConfig, init_opt_state, apply_updates
from repro_torch.train.train_step import build_train_step
from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["OptConfig", "init_opt_state", "apply_updates",
           "build_train_step", "CheckpointManager"]
