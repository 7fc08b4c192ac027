"""AdamW and learning-rate schedules over dict trees of tensors."""
from .adamw import AdamWConfig, AdamWState, apply, global_norm, init
from .schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "apply", "global_norm", "init",
           "constant", "warmup_cosine"]
