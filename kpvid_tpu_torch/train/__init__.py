"""Both training stages: the trainers, their optimizer, and the CLI
(``python -m kpvid_tpu_torch.train``, train/cli.py)."""

from .cli import main
from .stage1 import Stage1Trainer
from .stage2 import Stage2Trainer
from .state import make_lr_schedule, make_optimizer

__all__ = ["Stage1Trainer", "Stage2Trainer", "main", "make_lr_schedule", "make_optimizer"]
