"""Model zoo: the decoder-only LM (layers, GQA attention with RoPE or
M-RoPE and MLA through the flash kernel, the MoE FFN, the RWKV6 and Mamba
mixers, the transformer), the encoder-decoder (whisper), their weight
converter and the coded serving step (``models.coded``).  Ports
``repro/models``."""

from .convert import load_jax_params
from .encdec import EncDecLM
from .transformer import TransformerLM
from .zoo import build_model, input_shardings, input_specs

__all__ = ["build_model", "input_specs", "input_shardings", "load_jax_params",
           "EncDecLM", "TransformerLM"]
