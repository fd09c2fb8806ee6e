"""The coded matmul (the encode and all worker products, one launch) as
hand-written CUDA kernels on Hopper's tensor cores.

Ports ``repro/kernels/coded_matmul.py`` (the Pallas TPU kernel
``coded_matmul_kernel``).  The kernels are ``csrc/coded_matmul.cu``; its
source note says what bounds them on the H100 and how the design differs
from the TPU's.  Its plain version is ``kernels.ref.coded_matmul``.

  out[n] = (W @ blocks)[n] @ B
    W:      (N, J)       float32 coding matrix (J = K data + T noise blocks)
    blocks: (J, blk, d)  the round's stacked input blocks
    B:      (d, n_out)   the shared right factor
    out:    (N, blk, n_out), in blocks' dtype

One C entry point runs three passes: the encode (each coded value the
j-ordered fmaf chain of ``berrut_combine``) split into TF32 hi and lo
planes, the split of B^T, and an error-compensated 3xTF32 GEMM on the
tensor cores with float32 accumulation.  The coded shards reach device
memory once, as the two planes; this wrapper allocates the planes at the
extents the source's ``coded_matmul_scratch`` gives (its GEMM's tiles,
about 1 GB at the full qwen2-7b FFN width).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["coded_matmul_kernel"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def coded_matmul_kernel(weights: torch.Tensor, blocks: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """weights (N, J) float32; blocks (J, blk, d) and rhs (d, n_out), each
    float32 or bfloat16, all contiguous on one CUDA device
    -> (N, blk, n_out) in blocks' dtype.

    Launches the kernel on the current stream and adds one to
    ``coded_matmul_kernel.launches``.  There is no CPU path: a CPU tensor
    raises (``kernels.ops.coded_matmul`` picks the plain version for those).
    """
    tensors = (weights, blocks, rhs)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("coded_matmul_kernel runs on CUDA tensors only (got "
                         f"{[str(t.device) for t in tensors]})")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("weights, blocks and rhs must share one device")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if blocks.dtype not in _DTYPES or rhs.dtype not in _DTYPES:
        raise TypeError(f"blocks and rhs must be float32 or bfloat16, got "
                        f"{blocks.dtype} and {rhs.dtype}")
    if weights.dim() != 2 or blocks.dim() != 3 or rhs.dim() != 2 or \
            weights.shape[1] != blocks.shape[0] or \
            blocks.shape[2] != rhs.shape[0]:
        raise ValueError(f"need weights (N, J), blocks (J, blk, d), rhs "
                         f"(d, n_out); got {tuple(weights.shape)}, "
                         f"{tuple(blocks.shape)}, {tuple(rhs.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("coded_matmul_kernel needs contiguous tensors")
    n, j = weights.shape
    _, blk, d = blocks.shape
    n_out = rhs.shape[1]
    out = torch.empty((n, blk, n_out), dtype=blocks.dtype,
                      device=blocks.device)
    if out.numel() == 0:
        return out
    if d == 0 or j == 0:
        return out.zero_()
    pad = (ctypes.c_int64 * 3)()
    if _build.function("coded_matmul_scratch")(n, blk, d, n_out, pad) != 0:
        raise ValueError(f"coded_matmul_kernel refuses N * blk = {n * blk}, "
                         f"d = {d}, n_out = {n_out}: past its grids' limits")
    m_pad, d_pad, n_pad = pad
    # the split planes (hi, lo) of the coded shards and of B^T
    a_planes = torch.empty((2, m_pad, d_pad), dtype=torch.float32,
                           device=blocks.device)
    b_planes = torch.empty((2, n_pad, d_pad), dtype=torch.float32,
                           device=blocks.device)
    launch = _build.library("coded_matmul")
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(weights.data_ptr(), blocks.data_ptr(), rhs.data_ptr(),
                     out.data_ptr(), a_planes.data_ptr(),
                     b_planes.data_ptr(), n, j, blk, d, n_out,
                     _DTYPES[blocks.dtype], _DTYPES[rhs.dtype], stream)
    _build.check(err, "coded_matmul")
    coded_matmul_kernel.launches += 1
    return out


coded_matmul_kernel.launches = 0
