"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Ports ``repro/kernels/ref.py`` (``berrut_combine`` and ``coded_matmul``).
The CPU tests hold these against the JAX package, and ``chip_smoke.py``
holds each hand-written CUDA kernel against them on the card.  Both
accumulate in float32 and return the blocks' dtype.  A float32 product on
the card is full IEEE float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).
"""

from __future__ import annotations

import torch

__all__ = ["berrut_combine", "coded_matmul"]


def berrut_combine(weights: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """SPACDC encode/decode contraction: out[q] = Σ_j W[q,j]·blocks[j].

    weights (Q, J); blocks (J, M) (flattened block payload).  f32 accumulate.
    """
    return torch.matmul(weights.to(torch.float32),
                        blocks.to(torch.float32)).to(blocks.dtype)


def coded_matmul(weights: torch.Tensor, blocks: torch.Tensor,
                 rhs: torch.Tensor) -> torch.Tensor:
    """Fused coded-round twin, computed *unfused*: encode the blocks, then
    run each worker's matmul.

    weights (N, J); blocks (J, blk, d); rhs (d, n_out) -> (N, blk, n_out).
    f32 accumulate throughout.
    """
    flat = blocks.reshape(blocks.shape[0], -1).to(torch.float32)
    coded = torch.matmul(weights.to(torch.float32), flat)
    coded = coded.reshape((weights.shape[0],) + tuple(blocks.shape[1:]))
    return torch.matmul(coded, rhs.to(torch.float32)).to(blocks.dtype)
