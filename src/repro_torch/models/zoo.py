"""Model zoo: build an assigned architecture on one device.

Ports ``repro/models/zoo.py``'s ``build_model`` for every architecture of
``configs.ARCHS``: the encoder-decoder (whisper) as ``EncDecLM``, the rest
as the decoder-only ``TransformerLM`` (GQA with RoPE or Qwen2-VL's M-RoPE,
MLA, Mamba (jamba's hybrid) or RWKV6 mixers with a dense, MoE or no FFN).
The dry run's ``input_specs``/``input_shardings`` have no counterpart:
eager PyTorch needs no shape stand-ins.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..runtime.engine import resolve_device
from .encdec import EncDecLM
from .transformer import TransformerLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, *, device=None,
                seed: int = 0) -> TransformerLM | EncDecLM:
    """The model of ``cfg`` with its parameters initialised on ``device``
    from a ``torch.Generator`` seeded with ``seed``: weights N(0, 1/fan_in),
    the embedding table N(0, 0.02^2), biases 0 and norm scales 1, as the
    reference's ``init``.

    ``device=None`` means the card, and raises without one; the tests pass
    ``"cpu"``.  An ``encoder_decoder`` config builds an ``EncDecLM``.  What
    the port still lacks raises ``NotImplementedError`` when it is reached:
    the int8 KV cache (``init_cache``).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return EncDecLM(cfg, gen) if cfg.encoder_decoder else \
        TransformerLM(cfg, gen)
