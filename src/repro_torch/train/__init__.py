"""repro_torch.train — train step, loop, checkpointing, fault tolerance."""

from .checkpoint import CheckpointManager
from .loop import StragglerMonitor, TrainConfig, make_train_step, run
