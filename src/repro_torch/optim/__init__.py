"""repro_torch.optim — AdamW and its schedule."""

from . import adamw
from .adamw import AdamWConfig
