"""Gradient compression for the coded aggregation path.

Ports ``repro/dist/compression.py``: symmetric per-tensor int8
quantization, one float32 scale per tensor, values rounded to the nearest
of 255 levels in [-127·s, 127·s].  The round-trip error is at most s/2
elementwise.  ``torch.round`` rounds half to even, as ``jnp.round``, so
``q`` and ``scale`` are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["int8_compress", "int8_compress_shared", "int8_decompress"]

_QMAX = 127.0


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any float shape) -> (q int8 of x's shape, scale float32 scalar),
    on x's device.

    scale = max|x| / 127 (1.0 for an all-zero tensor, so decompression is
    exact there); q = round(x / scale), never beyond ±127 because the
    scale comes from the max.
    """
    (q,), scale = int8_compress_shared([x])
    return q, scale


def int8_compress_shared(xs) -> Tuple[list, torch.Tensor]:
    """Several tensors under ONE scale: (their int8 q's, the float32
    scale).  ``max|x|`` runs over all of them, so the q's and the scale are
    those of :func:`int8_compress` of the tensors stacked into one.  The
    train step compresses the layers that the reference stacks into one
    leaf this way."""
    xfs = [torch.as_tensor(x).to(torch.float32) for x in xs]
    amax = torch.stack([xf.abs().max() for xf in xfs]).max()
    scale = torch.where(amax > 0, amax / _QMAX,
                        torch.ones_like(amax)).to(torch.float32)
    return [torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
            .to(torch.int8) for xf in xfs], scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int8_compress` (up to the s/2 rounding error)."""
    return q.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32,
                                                 device=q.device)
