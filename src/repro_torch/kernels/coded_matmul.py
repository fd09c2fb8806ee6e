"""The fused coded matmul (encode and all worker products in one pass) as a
hand-written CUDA kernel.

Ports ``repro/kernels/coded_matmul.py`` (the Pallas TPU kernel
``coded_matmul_kernel``).  The kernel itself is ``csrc/coded_matmul.cu``;
its source note says what bounds it on the H100 and how its layout differs
from the TPU's.  Its plain version is ``kernels.ref.coded_matmul``.

  out[n] = (W @ blocks)[n] @ B
    W:      (N, J)       float32 coding matrix (J = K data + T noise blocks)
    blocks: (J, blk, d)  the round's stacked input blocks
    B:      (d, n_out)   the shared right factor
    out:    (N, blk, n_out), in blocks' dtype

The coded shards (N, blk, d) never reach device memory.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["coded_matmul_kernel", "MAX_J", "ROW_TILE"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_J = 1024        # the W row the kernel stages in shared memory
ROW_TILE = 64       # rows of blk per thread block (grid.y <= 65535 tiles)


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
    if j > MAX_J:
        raise ValueError(f"coded_matmul_kernel takes J <= {MAX_J}, got {j}")
    if -(-blk // ROW_TILE) > 65535:
        raise ValueError(f"coded_matmul_kernel takes blk <= "
                         f"{ROW_TILE * 65535}, got {blk}")
    out = torch.empty((n, blk, n_out), dtype=blocks.dtype,
                      device=blocks.device)
    if out.numel() == 0:
        return out
    if d == 0 or j == 0:
        return out.zero_()
    launch = _build.library("coded_matmul")
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(weights.data_ptr(), blocks.data_ptr(), rhs.data_ptr(),
                     out.data_ptr(), n, j, blk, d, n_out,
                     _DTYPES[blocks.dtype], _DTYPES[rhs.dtype], stream)
    _build.check(err, "coded_matmul")
    coded_matmul_kernel.launches += 1
    return out


coded_matmul_kernel.launches = 0
