"""The MEA-ECC mask add/sub over F_q limb planes as a hand-written CUDA
kernel.

Ports ``repro/kernels/mask_add.py`` (the Pallas TPU kernel
``mask_add_kernel``).  The kernel itself is ``csrc/mask_add.cu``; its source
note says what bounds it on the H100 and why it keeps the (M, L) layout
where the TPU kernel transposed to limb planes.  Its plain version is
``kernels.ref.mask_add``.

  out = (payload ± mask) mod q
    payload: (M, L)  32-bit limbs (torch.uint32, or int32 holding the bits)
    mask:    (G, L)  G rows spread evenly over the M payload rows: payload
                     row m is masked by row m // (M // G).  G = M is a full
                     mask; G = N channels gives each channel one mask row
                     (paper mode's Ψ is never expanded to (M, L)); G = 1 is
                     one scalar for every element.
    out:     (M, L)  in the payload's dtype
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["mask_add_kernel", "MAX_LIMBS"]

_WORDS = (torch.uint32, torch.int32)
MAX_LIMBS = 16      # the q limbs the kernel takes as an argument


def mask_add_kernel(payload: torch.Tensor, mask: torch.Tensor, q_limbs,
                    *, subtract: bool = False) -> torch.Tensor:
    """payload (M, L) and mask (G, L), 32-bit words, contiguous on one CUDA
    device, M a multiple of G; ``q_limbs`` the L little-endian uint32 limbs
    of the modulus -> (M, L) (payload ± mask) mod q in the payload's dtype.

    Launches the kernel on the current stream and adds one to
    ``mask_add_kernel.launches``.  There is no CPU path: a CPU tensor raises
    (``kernels.ops.mask_add`` picks the plain version for those).
    """
    if not (payload.is_cuda and mask.is_cuda):
        raise ValueError("mask_add_kernel runs on CUDA tensors only (got "
                         f"{payload.device} and {mask.device})")
    if payload.device != mask.device:
        raise ValueError(f"payload on {payload.device}, mask on "
                         f"{mask.device}")
    if payload.dtype not in _WORDS or mask.dtype not in _WORDS:
        raise TypeError(f"payload and mask must be uint32 or int32 words, "
                        f"got {payload.dtype} and {mask.dtype}")
    if payload.dim() != 2 or mask.dim() != 2 or \
            mask.shape[1] != payload.shape[1]:
        raise ValueError(f"need payload (M, L) and mask (G, L), got "
                         f"{tuple(payload.shape)} and {tuple(mask.shape)}")
    if not (payload.is_contiguous() and mask.is_contiguous()):
        raise ValueError("mask_add_kernel needs contiguous tensors")
    m, n_limbs = payload.shape
    g = mask.shape[0]
    q_limbs = [int(v) for v in q_limbs]
    if len(q_limbs) != n_limbs or not 1 <= n_limbs <= MAX_LIMBS:
        raise ValueError(f"need 1 <= L <= {MAX_LIMBS} limbs of q, got "
                         f"{len(q_limbs)} for L = {n_limbs}")
    out = torch.empty_like(payload)
    if m == 0:
        return out
    if g == 0 or m % g:
        raise ValueError(f"{m} payload rows do not split evenly over {g} "
                         "mask rows")
    vec = n_limbs % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (payload, mask, out))
    q_arg = (ctypes.c_uint32 * n_limbs)(*q_limbs)
    launch = _build.library("mask_add")
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(payload.data_ptr(), mask.data_ptr(), out.data_ptr(), m,
                     n_limbs, m // g, q_arg, int(subtract), int(vec), stream)
    _build.check(err, "mask_add")
    mask_add_kernel.launches += 1
    return out


mask_add_kernel.launches = 0
