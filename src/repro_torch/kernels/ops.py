"""Device-dispatching wrappers for the port's CUDA kernels.

Ports ``repro/kernels/ops.py`` (``berrut_combine``, ``prefix_decode``,
``coded_matmul``, ``precoded_matmul``, ``mask_add`` with the MEA-ECC
cipher cores, the encrypted round, and ``flash_attention``).
``force_kernel`` keeps the reference's tri-state, read for the device
instead of the TPU:

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
from .flash_attention import flash_attention_kernel
from .mask_add import mask_add_kernel

__all__ = ["berrut_combine", "prefix_decode", "coded_matmul",
           "precoded_matmul", "mask_add",
           "mea_encrypt_core", "mea_decrypt_core", "encrypted_coded_matmul",
           "fused_wire", "flash_attention", "kernel_launches",
           "kernel_launch_counts"]


def _use_kernel(t: torch.Tensor, force_kernel) -> bool:
    if force_kernel is None:
        return t.is_cuda
    if force_kernel and not t.is_cuda:
        raise ValueError("force_kernel=True needs CUDA tensors: the CUDA "
                         "kernels have no CPU or interpret mode")
    return bool(force_kernel)


def kernel_launch_counts() -> dict:
    """Launches of each of the port's kernels so far in this process (the
    wrappers' counters), by kernel name."""
    return {"berrut_combine": berrut_encode_kernel.launches,
            "coded_matmul": coded_matmul_kernel.launches,
            "mask_add": mask_add_kernel.launches,
            "flash_attention": flash_attention_kernel.launches}


def kernel_launches() -> int:
    """Launches of the port's kernels so far in this process (the sum of
    the wrappers' counters)."""
    return sum(kernel_launch_counts().values())


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
    kernel path one launch encodes the coded shards once into TF32 split
    planes and runs the worker products on the tensor cores at float32
    accuracy; the plain version computes the same contraction unfused.
    """
    weights = torch.as_tensor(weights).to(device=blocks.device,
                                          dtype=torch.float32)
    if _use_kernel(blocks, force_kernel):
        return coded_matmul_kernel(weights.contiguous(), blocks.contiguous(),
                                   rhs.contiguous())
    return ref.coded_matmul(weights, blocks, rhs)


def precoded_matmul(shards, x, weights, *, force_kernel: bool | None = None,
                    wire=None):
    """Serving-side coded matmul against PRE-ENCODED weight shards.

    ``shards`` (N, blk, d_in) — ``scheme.encode(W^T)``, resident at the
    workers; ``x`` (B, d_in) per-step activations; ``weights`` (K, N) —
    the masked decode matrix of the step's responder set.  Returns the
    decoded (K, blk, B) row blocks of ``(x @ W)^T``.

    The worker products ``shards[n] @ x^T`` (the reference's einsum
    ``"nbd,Bd->nbB"``, outside any Pallas kernel there too) are one float32
    ``torch.bmm`` over ``x`` broadcast to every worker (IEEE: the package
    never turns TF32 on).  ``wire(payload, leg)``, when given, carries the
    (N, B, d_in) activations out (leg 0) and the (N, blk, B) results back
    (leg 1), each worker its own channel (``models.coded``'s in-step
    wire); it must return its payload bit for bit, so the wired and the
    plain products are the same bits.  The decode is
    :func:`berrut_combine`, the CUDA kernel for CUDA tensors.
    """
    xf = x.to(torch.float32)
    xs = xf[None].expand((shards.shape[0],) + tuple(xf.shape)).contiguous()
    if wire is not None:
        xs = wire(xs, 0)
    results = torch.bmm(shards.to(torch.float32), xs.transpose(1, 2))
    if wire is not None:
        results = wire(results, 1)
    return berrut_combine(weights, results, force_kernel=force_kernel)


def _mask_rows(mask: torch.Tensor, shape) -> torch.Tensor:
    """A mask broadcast against limbs of ``shape`` (..., L) -> the (G, L)
    rows the kernel spreads over the flattened payload.  A mask that
    matches the leading dims and is 1 on the rest (paper mode's per-channel
    Ψ, a scalar mask) keeps its G rows; any other broadcast is expanded."""
    nd = len(shape)
    mask = mask.view(torch.int32)
    mask = mask.reshape((1,) * (nd - mask.dim()) + tuple(mask.shape))
    k = 0
    while k < nd - 1 and mask.shape[k] == shape[k]:
        k += 1
    if all(mask.shape[i] == 1 for i in range(k, nd - 1)):
        g = 1
        for dim in shape[:k]:
            g *= dim
        return mask.reshape(g, shape[-1]).contiguous()
    return mask.expand(tuple(shape)).reshape(-1, shape[-1]).contiguous()


def _limb_ready(limbs, mask, q: int, use_kernel: bool, subtract: bool):
    """Shared tail of the cipher cores and the general wire: (limbs ± mask)
    mod q over (..., L) 32-bit limbs, ``mask`` broadcast against them,
    through the CUDA kernel or its plain version.  Returns
    ``torch.uint32``."""
    from ..crypto import field
    q_limbs = tuple(int(v) for v in field.int_to_limbs(q, limbs.shape[-1]))
    if not use_kernel:
        return ref.mask_add(limbs, mask, q_limbs, subtract=subtract)
    shape = tuple(limbs.shape)
    # int32 views of the words: every copy below then runs on int32
    out = mask_add_kernel(limbs.view(torch.int32).reshape(-1, shape[-1])
                          .contiguous(), _mask_rows(mask, shape), q_limbs,
                          subtract=subtract)
    return out.reshape(shape).view(torch.uint32)


def mask_add(payload, mask, q: int, *, subtract=False,
             force_kernel: bool | None = None):
    """MEA-ECC mask add/sub with kernel dispatch.

    (payload ± mask) mod q over 32-bit limb planes ``(..., L)`` — the
    encrypt/decrypt step of the cipher (``crypto.mea_ecc``).  ``q`` is the
    modulus as a python int.  ``mask`` broadcasts against ``payload``
    (paper mode passes one mask element).  numpy uint32 arrays are taken
    as CPU tensors.  Returns ``torch.uint32`` on the payload's device.
    """
    from ..crypto import field
    payload = field.as_u32_tensor(payload)
    mask = field.as_u32_tensor(mask, payload.device)
    return _limb_ready(payload, mask, q, _use_kernel(payload, force_kernel),
                       subtract)


def _core_mask(mask_material, mode: str, n: int, n_limbs: int):
    from ..crypto import field
    if mode == "stream":
        # mask_material = (8,) uint32 PRF seed words
        return field.stream_mask_traced(mask_material, n, n_limbs)
    return mask_material                       # paper: (L,) psi limbs


def mea_encrypt_core(data, mask_material, *, q: int, frac_bits: int,
                     mode: str, codec: str, n_limbs: int,
                     force_kernel: bool | None = None):
    """One MEA-ECC encrypt: codec embed + mask PRF + limb add.

    ``data`` is (n,) float (codec="fixed") or (n,) 32-bit raw words
    (codec="bits"); returns the (n, L) ``torch.uint32`` payload limbs on
    the data's device.  The limb add is the CUDA ``mask_add`` kernel for
    CUDA tensors.
    """
    from ..crypto import field
    if codec == "fixed":
        limbs = field.fixed_encode_traced(data, q, frac_bits, n_limbs)
    else:
        limbs = field.embed_limbs(field.as_u32_tensor(data), n_limbs)
    mask = _core_mask(field.as_u32_tensor(mask_material, limbs.device), mode,
                      limbs.shape[0], n_limbs)
    return _limb_ready(limbs, mask, q, _use_kernel(limbs, force_kernel),
                       subtract=False)


def mea_decrypt_core(payload, mask_material, *, q: int, frac_bits: int,
                     mode: str, codec: str,
                     force_kernel: bool | None = None):
    """One MEA-ECC decrypt: limb subtract + codec extract.

    Returns (n,) float32 (codec="fixed") or (n,) ``torch.uint32`` raw words
    (codec="bits").
    """
    from ..crypto import field
    payload = field.as_u32_tensor(payload)
    n, n_limbs = payload.shape
    mask = _core_mask(field.as_u32_tensor(mask_material, payload.device),
                      mode, n, n_limbs)
    unmasked = _limb_ready(payload, mask, q,
                           _use_kernel(payload, force_kernel), subtract=True)
    if codec == "fixed":
        return field.fixed_decode_traced(unmasked, q, frac_bits)
    return unmasked.view(torch.int32)[:, 0].contiguous().view(torch.uint32)


def encrypted_coded_matmul(weights, blocks, rhs, material_out, material_back,
                           *, q: int, mode: str,
                           force_kernel: bool | None = None,
                           return_wire: bool = False):
    """The encrypted round with kernel dispatch: encode -> MEA-ECC wire-out
    -> worker products -> MEA-ECC wire-back (``kernels.encrypted_round``).

    On the kernel path (CUDA tensors) the wires are the general cipher
    through the CUDA ``mask_add`` kernel, the encode ``berrut_combine`` and
    the products ``coded_matmul``; the plain path runs the fast wires
    between plain matmuls.  ``return_wire`` also returns the (N, W, L)
    out/back ciphertext limbs.
    """
    from .encrypted_round import encrypted_coded_matmul as _impl
    return _impl(weights, blocks, rhs, material_out, material_back, q=q,
                 mode=mode, use_kernel=_use_kernel(blocks, force_kernel),
                 return_wire=return_wire)


def fused_wire(words, material, *, q: int, mode: str,
               force_kernel: bool | None = None):
    """A standalone wire round trip (encrypt + decrypt) over (N, W) 32-bit
    payload words; returns the (N, W) ``torch.uint32`` words.  The
    reference pads W to power-of-two buckets to bound its jit compiles;
    eager PyTorch compiles nothing per shape, so W stays as it is."""
    from ..crypto import field
    from .encrypted_round import wire_roundtrip
    words = field.as_u32_tensor(words)
    x = words.view(torch.int32).view(torch.float32)
    out = wire_roundtrip(x, material, q=q, mode=mode,
                         use_kernel=_use_kernel(words, force_kernel))
    return out.view(torch.int32).view(torch.uint32)


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0,
                    force_kernel: bool | None = None):
    """GQA attention forward with kernel dispatch.

    q (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, hd_v) -> (B, Sq,
    H, hd_v) in q's dtype, scaled by 1/sqrt(hd); hd_v < hd is MLA's
    prefill.  Positions are implicit, ``arange`` from 0 for both q and k.  On the
    kernel path the CUDA flash kernel reads q, k and v in place through
    their strides (unit stride along hd); the plain version is the dense
    ``ref.mha_reference``.
    """
    if _use_kernel(q, force_kernel):
        return flash_attention_kernel(q, k, v, causal=causal,
                                      softcap=softcap)
    return ref.mha_reference(q, k, v, causal=causal, softcap=softcap)
