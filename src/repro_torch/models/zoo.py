"""Model zoo: build an assigned architecture, and its input specs.

Ports ``repro/models/zoo.py``: ``build_model`` for every architecture of
``configs.ARCHS`` (the encoder-decoder (whisper) as ``EncDecLM``, the rest
as the decoder-only ``TransformerLM``: GQA with RoPE or Qwen2-VL's M-RoPE,
MLA, Mamba (jamba's hybrid) or RWKV6 mixers with a dense, MoE or no FFN),
``input_specs`` (shape and dtype stand-ins of every model input of a
shape cell, as ``torch.empty(..., device="meta")``) and
``input_shardings`` (their placements, batch over the data axes).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..dist.sharding import P, NamedSharding, placements_of, resolve_spec
from ..runtime.engine import resolve_device
from .encdec import EncDecLM
from .transformer import TransformerLM

__all__ = ["build_model", "input_specs", "input_shardings"]


def build_model(cfg: ModelConfig, *, device=None,
                seed: int = 0) -> TransformerLM | EncDecLM:
    """The model of ``cfg`` with its parameters initialised on ``device``
    from a ``torch.Generator`` seeded with ``seed``: weights N(0, 1/fan_in),
    the embedding table N(0, 0.02^2), biases 0 and norm scales 1, as the
    reference's ``init``.

    ``device=None`` means the card, and raises without one; the tests pass
    ``"cpu"``.  ``device="meta"`` builds empty parameters (shapes and
    dtypes only, no draw: the dry run's).  An ``encoder_decoder`` config
    builds an ``EncDecLM``.
    """
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return EncDecLM(cfg, gen) if cfg.encoder_decoder else \
        TransformerLM(cfg, gen)


class _MetaGenerator:
    """What the initializers read of a generator on the meta device, which
    has none: its device (they then make empty tensors)."""
    device = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shape and dtype stand-ins (meta tensors, no allocation) for every
    model input of a shape cell.  Modality frontends are stubs: whisper
    gets precomputed frame embeddings, qwen2-vl gets M-RoPE position
    streams beside its text tokens."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def meta(shape_, dtype=i32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            sd = max(s // cfg.dec_len_ratio, 16)
            return {"frames": meta((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": meta((b, sd)), "targets": meta((b, sd))}
        batch = {"tokens": meta((b, s)), "targets": meta((b, s))}
        if cfg.mrope_sections:
            batch["mrope_positions"] = meta((3, b, s))
        return batch

    # decode: one new token against a seq_len cache
    batch = {"tokens": meta((b, 1))}
    if cfg.mrope_sections:
        batch["mrope_positions"] = meta((3, b, 1))
    return batch


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, data_axes):
    """``NamedSharding``s matching ``input_specs``: batch over the data
    axes (the M-RoPE streams' batch is their second dim)."""
    def shard(name, sds):
        if name == "mrope_positions":
            spec = P(None, data_axes, None)
        else:
            spec = P(*((data_axes,) + (None,) * (sds.dim() - 1)))
        spec = resolve_spec(spec, tuple(sds.shape), mesh)
        return NamedSharding(mesh, spec, placements_of(spec, mesh))

    return {k: shard(k, v) for k, v in input_specs(cfg, shape).items()}
