"""Model zoo: the dense decoder-only LM (layers, GQA attention through the
flash kernel, the transformer), its weight converter and the coded serving
step (``models.coded``).  Ports ``repro/models`` for the dense attention
architectures."""

from .convert import load_jax_params
from .transformer import TransformerLM
from .zoo import build_model

__all__ = ["build_model", "load_jax_params", "TransformerLM"]
