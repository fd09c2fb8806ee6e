"""The SPACDC Berrut encode/decode contraction as a hand-written CUDA kernel.

Ports ``repro/kernels/berrut_encode.py`` (the Pallas TPU kernel
``berrut_encode_kernel``).  The kernel itself is ``csrc/berrut_combine.cu``;
its source note says what bounds it on the H100 and how its layout differs
from the TPU's.  Its plain version is ``kernels.ref.berrut_combine``.

out[q, m] = Σ_j W[q, j] · B[j, m]
  W: (Q, J) float32 coding matrix (Q = N workers on encode, K blocks on decode)
  B: (J, M) float32 or bfloat16 stacked block payloads (M large)
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["berrut_encode_kernel"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def berrut_encode_kernel(weights: torch.Tensor,
                         blocks: torch.Tensor) -> torch.Tensor:
    """weights (Q, J) float32; blocks (J, M) float32 or bfloat16, both
    contiguous on one CUDA device -> (Q, M) in blocks' dtype.

    Launches the kernel on the current stream and adds one to
    ``berrut_encode_kernel.launches``.  There is no CPU path: a CPU tensor
    raises (``kernels.ops.berrut_combine`` picks the plain version for those).
    """
    if not (weights.is_cuda and blocks.is_cuda):
        raise ValueError("berrut_encode_kernel runs on CUDA tensors only "
                         f"(got {weights.device} and {blocks.device})")
    if weights.device != blocks.device:
        raise ValueError(f"weights on {weights.device}, blocks on "
                         f"{blocks.device}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"blocks must be float32 or bfloat16, got "
                        f"{blocks.dtype}")
    if weights.dim() != 2 or blocks.dim() != 2 or \
            weights.shape[1] != blocks.shape[0]:
        raise ValueError(f"need weights (Q, J) and blocks (J, M), got "
                         f"{tuple(weights.shape)} and {tuple(blocks.shape)}")
    if not (weights.is_contiguous() and blocks.is_contiguous()):
        raise ValueError("berrut_encode_kernel needs contiguous tensors")
    q, j = weights.shape
    m = blocks.shape[1]
    out = torch.empty((q, m), dtype=blocks.dtype, device=blocks.device)
    if out.numel() == 0:
        return out
    if j == 0:
        return out.zero_()
    launch = _build.library("berrut_combine")
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(weights.data_ptr(), blocks.data_ptr(), out.data_ptr(),
                     q, j, m, _DTYPES[blocks.dtype], stream)
    _build.check(err, "berrut_combine")
    berrut_encode_kernel.launches += 1
    return out


berrut_encode_kernel.launches = 0
