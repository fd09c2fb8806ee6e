"""Model zoo: the decoder-only LM (layers, GQA and MLA attention through
the flash kernel, the MoE FFN, the RWKV6 and Mamba mixers, the
transformer), its weight converter and the coded serving step
(``models.coded``).  Ports ``repro/models`` for the decoder-only
architectures."""

from .convert import load_jax_params
from .transformer import TransformerLM
from .zoo import build_model

__all__ = ["build_model", "load_jax_params", "TransformerLM"]
