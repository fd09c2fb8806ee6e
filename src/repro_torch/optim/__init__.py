"""Optimizers: AdamW, SGD with momentum, warmup-cosine, global-norm
clipping, ZeRO-1's state placement.  Ports ``repro/optim``."""

from .optimizers import (OptState, Optimizer, adamw, apply_updates,
                         clip_by_global_norm, global_norm, place_state,
                         sgdm, warmup_cosine)

__all__ = ["OptState", "Optimizer", "adamw", "sgdm", "apply_updates",
           "clip_by_global_norm", "global_norm", "warmup_cosine",
           "place_state"]
