"""Atomic, integrity-checked, optionally MEA-ECC-encrypted checkpoints.
Ports ``repro/checkpoint``."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
