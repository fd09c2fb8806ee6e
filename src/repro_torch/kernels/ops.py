"""Device-dispatching wrappers for the port's CUDA kernels.

Ports ``repro/kernels/ops.py`` (``berrut_combine``, ``prefix_decode`` and
``coded_matmul``).  ``force_kernel`` keeps the reference's tri-state, read
for the device instead of the TPU:

* ``None`` — the hand-written CUDA kernel for CUDA tensors, the plain
  PyTorch version (``kernels.ref``) for CPU tensors;
* ``True`` — the kernel; CPU tensors raise (a CUDA kernel has no
  interpret mode);
* ``False`` — the plain version on either device.

A kernel that fails to build or to launch raises: nothing falls back to the
plain version.
"""

from __future__ import annotations

import torch

from . import ref
from .berrut_encode import berrut_encode_kernel
from .coded_matmul import coded_matmul_kernel

__all__ = ["berrut_combine", "prefix_decode", "coded_matmul",
           "kernel_launches"]


def _use_kernel(t: torch.Tensor, force_kernel) -> bool:
    if force_kernel is None:
        return t.is_cuda
    if force_kernel and not t.is_cuda:
        raise ValueError("force_kernel=True needs CUDA tensors: the CUDA "
                         "kernels have no CPU or interpret mode")
    return bool(force_kernel)


def kernel_launches() -> int:
    """Launches of the port's kernels so far in this process (the sum of
    the wrappers' counters)."""
    return berrut_encode_kernel.launches + coded_matmul_kernel.launches


def berrut_combine(weights, blocks, *, force_kernel: bool | None = None):
    """Coding-scheme encode/decode contraction with kernel dispatch.

    ``weights`` (Q, J); ``blocks`` any (J, ...) payload, flattened
    internally.  Returns (Q, ...) in blocks' dtype; weights are moved to the
    blocks' device as float32.
    """
    j = blocks.shape[0]
    flat = blocks.reshape(j, -1)
    weights = torch.as_tensor(weights).to(device=blocks.device,
                                          dtype=torch.float32)
    if _use_kernel(flat, force_kernel):
        out = berrut_encode_kernel(weights.contiguous(), flat.contiguous())
    else:
        out = ref.berrut_combine(weights, flat)
    return out.reshape((weights.shape[0],) + tuple(blocks.shape[1:]))


def prefix_decode(weights, results, *, force_kernel: bool | None = None):
    """Batched prefix-masked decode: every responder prefix of a round in
    ONE contraction.

    ``weights`` (E, K, N) stacked decode matrices, one per responder prefix;
    ``results`` (N, ...) the workers' outputs.  Returns (E, K, ...): row e
    is what decoding after the (e+1)-th arrival would have yielded.  The
    prefix axis folds into the output-row axis of :func:`berrut_combine`.
    """
    weights = torch.as_tensor(weights, dtype=torch.float32)
    e, k, n = weights.shape
    out = berrut_combine(weights.reshape(e * k, n), results,
                         force_kernel=force_kernel)
    return out.reshape((e, k) + tuple(out.shape[1:]))


def coded_matmul(weights, blocks, rhs, *, force_kernel: bool | None = None):
    """Fused encode + batched worker matmul with kernel dispatch.

    out[n] = (weights @ blocks)[n] @ rhs — the round hot path of every
    linear data-coded scheme (``SchemeDefaults.fused_round``).  On the
    kernel path the coded shards never reach device memory; the plain
    version computes the same contraction unfused.
    """
    weights = torch.as_tensor(weights).to(device=blocks.device,
                                          dtype=torch.float32)
    if _use_kernel(blocks, force_kernel):
        return coded_matmul_kernel(weights.contiguous(), blocks.contiguous(),
                                   rhs.contiguous())
    return ref.coded_matmul(weights, blocks, rhs)
