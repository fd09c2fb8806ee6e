"""The SPACDC Berrut encode/decode contraction as a hand-written CUDA kernel.

Ports ``repro/kernels/berrut_encode.py`` (the Pallas TPU kernel
``berrut_encode_kernel``).  The kernel itself is ``csrc/berrut_combine.cu``:
a persistent streaming kernel, one block per SM, whose producer warp feeds
512-column tiles of the payload into a ring of shared-memory stages (TMA,
or bulk copies read at each row's byte shift where TMA's 16-byte rule
fails) while eight consumer warps run each output's j-ordered float32
``fmaf`` chain.  Its source note says what bounds it on the H100 and why
the chain keeps it off the tensor cores.  Its plain version is
``kernels.ref.berrut_combine``.

out[q, m] = Σ_j W[q, j] · B[j, m]
  W: (Q, J) float32 coding matrix (Q = N workers on encode, K blocks on decode)
  B: (J, M) float32 or bfloat16 stacked block payloads (M large)
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["berrut_encode_kernel", "load_path", "kernel_name"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_COLS = 512     # the kernel's payload columns per tile


def load_path(blocks: torch.Tensor) -> str:
    """How the kernel loads a (J, M) payload, from its address and M alone
    (``load_path`` in ``csrc/berrut_combine.cu``, whose C twin
    ``berrut_combine_load_path`` the card tests hold this to): ``"tma"``
    when the address and the row stride M * elt are 16-byte aligned (and
    M fits TMA's int32 coordinates), else ``"bulk"``: bulk copies of the
    16-byte aligned bytes around each row segment, read at the row's byte
    shift."""
    m = blocks.shape[1]
    aligned = blocks.data_ptr() % 16 == 0 and \
        (m * blocks.element_size()) % 16 == 0
    return "tma" if aligned and m <= 0x7FFFFFFF - _TILE_COLS else "bulk"


def kernel_name(q: int, blocks: torch.Tensor) -> str:
    """The kernel instantiation a launch with Q output rows and payload
    ``blocks`` runs (its rows per thread, RT, as ``rows_per_thread`` in the
    source picks it, and whether rows may be shifted, the bulk path), as
    the toolkit's ``cu++filt`` writes it in ptxas's report."""
    rt = 4 if q <= 8 else 8 if q <= 16 else 12 if q <= 24 else 16
    ctype = "float" if blocks.dtype == torch.float32 else "__nv_bfloat16"
    shifted = int(load_path(blocks) == "bulk")
    return f"berrut_stream_kernel<{ctype}, (int){rt}, (bool){shifted}>"


def berrut_encode_kernel(weights: torch.Tensor,
                         blocks: torch.Tensor) -> torch.Tensor:
    """weights (Q, J) float32; blocks (J, M) float32 or bfloat16, both
    contiguous on one CUDA device -> (Q, M) in blocks' dtype.

    Launches the kernel once on the current stream and adds one to
    ``berrut_encode_kernel.launches``; its load path is ``load_path(blocks)``.
    There is no CPU path: a CPU tensor raises (``kernels.ops.berrut_combine``
    picks the plain version for those).
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
