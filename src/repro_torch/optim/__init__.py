"""Optimizers: AdamW, SGD with momentum, warmup-cosine, global-norm
clipping.  Ports ``repro/optim``."""

from .optimizers import (OptState, Optimizer, adamw, apply_updates,
                         clip_by_global_norm, global_norm, sgdm,
                         warmup_cosine)

__all__ = ["OptState", "Optimizer", "adamw", "sgdm", "apply_updates",
           "clip_by_global_norm", "global_norm", "warmup_cosine"]
