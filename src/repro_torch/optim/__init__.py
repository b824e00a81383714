from .optimizers import (Optimizer, adamw, apply_updates, clip_by_global_norm,
                         global_norm, sgd)
from .schedules import constant, warmup_cosine

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates", "global_norm",
           "clip_by_global_norm", "constant", "warmup_cosine"]
