"""Model zoo: build an assigned architecture on one device.

Ports ``repro/models/zoo.py``'s ``build_model`` for the decoder-only
attention architectures (``TransformerLM``): GQA or MLA mixers with a dense
or MoE FFN.  The dry run's
``input_specs``/``input_shardings`` have no counterpart: eager PyTorch
needs no shape stand-ins.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..runtime.engine import resolve_device
from .transformer import TransformerLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, *, device=None,
                seed: int = 0) -> TransformerLM:
    """The model of ``cfg`` with its parameters initialised on ``device``
    from a ``torch.Generator`` seeded with ``seed``: weights N(0, 1/fan_in),
    the embedding table N(0, 0.02^2), biases 0 and norm scales 1, as the
    reference's ``init``.

    ``device=None`` means the card, and raises without one; the tests pass
    ``"cpu"``.  Encoder-decoder, SSM (mamba, rwkv) and M-RoPE configs
    raise ``NotImplementedError`` (later slices).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return TransformerLM(cfg, gen)
