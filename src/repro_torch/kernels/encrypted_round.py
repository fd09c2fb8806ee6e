"""The encrypted round: the MEA-ECC wire fused into the coded-matmul round.

Ports ``repro/kernels/encrypted_round.py``.  ``encrypted_coded_matmul`` is
the body of an ``encrypt="real"`` round: encode -> wire-out (the master
encrypts every coded shard, its worker decrypts) -> the worker products ->
wire-back (every worker encrypts its product, the master decrypts).  Each
wire is a genuine cipher application: the payload crosses as (n, L) 32-bit
field-element limbs masked with the same material the staged ``MEAECC``
path derives, and each channel's SHA-256 keystream is generated once per
transfer and shared by the mask add and the mask subtract.

Three wires, as in the reference:

* **general** (``use_kernel=True``, the card's path): the bits embed, the
  full mask limb planes, and ``(x + mask) mod q`` then ``(ct - mask) mod
  q`` through ``ops._limb_ready`` — the hand-written CUDA ``mask_add``
  kernel for CUDA tensors.  Paper mode's mask stays one Ψ row per channel.
  The worker products go through the ``coded_matmul`` kernel with identity
  weights, and the encode through the ``berrut_combine`` kernel.
* **stream fast** and **paper fast** (``use_kernel=False``): the exact
  specialisations of the bits-codec wire.  Stream: payload < 2^32 and mask
  < 2^64, so the sum never reaches a >64-bit q and the ciphertext is 3 live
  limb planes.  Paper: Ψ is channel-constant, so the work is one add, two
  compares and a select per word.  Both are bit-identical to the general
  wire (held by the tests), and the encode and products are plain
  ``torch.matmul`` in the order of ``ref.coded_matmul``, so this path is
  bit-identical to the plain round.

``jax.lax.optimization_barrier`` has no counterpart in eager PyTorch: every
ciphertext is a tensor that exists before it is decrypted.  The bit
twiddling of the reference's uint32 arithmetic runs in int64 here, masked to
32 bits (``crypto.field.to_i64`` / ``to_u32``).
"""

from __future__ import annotations

import torch

from ..crypto import field

__all__ = ["wire_roundtrip", "encrypted_coded_matmul"]

_M32 = 0xFFFFFFFF


def _n_limbs(q: int) -> int:
    return max(-(-q.bit_length() // 32), 1)


def _q_limbs(q: int, n_limbs: int):
    return tuple(int(v) for v in field.int_to_limbs(q, n_limbs))


def _general_mask(material, mode: str, n_words: int, n_limbs: int):
    """The mask the staged cores derive: (N, n_words, L) stream limbs, or
    the (N, 1, L) Ψ rows of paper mode (one per channel, not expanded)."""
    if mode == "stream":
        lo, hi = field.keystream_words_traced_batched(material, n_words)
        mask = torch.zeros(tuple(lo.shape) + (n_limbs,), dtype=torch.int32,
                           device=lo.device)
        mask[..., 0] = lo.view(torch.int32)
        mask[..., 1] = hi.view(torch.int32)
        return mask.view(torch.uint32)
    return material[:, None, :]


def _paper_channel_consts(psi, q: int, n_limbs: int):
    """Per-channel constants of the paper fast wire from the (N, L) Ψ
    limbs, as int64: (psi0, psi_hi, psi_hi_plus1, thr0, ovf_possible).

    thr = q - Ψ is the single-limb overflow threshold: w + Ψ >= q iff
    thr < 2^32 and w >= thr (w < 2^32).
    """
    ql = _q_limbs(q, n_limbs)
    psi = field.to_i64(psi)
    psi0 = psi[:, 0]
    psi_hi = psi[:, 1:]
    # psi_hi + 1 with a carry chain over the L-1 high limbs
    plus1 = []
    carry = 1
    for j in range(n_limbs - 1):
        s = psi_hi[:, j] + carry
        carry = s >> 32
        plus1.append(s & _M32)
    psi_hi1 = torch.stack(plus1, dim=-1) if plus1 else psi_hi
    # thr = q - Ψ (Ψ < q, so no borrow out of the top limb)
    thr = []
    borrow = 0
    for j in range(n_limbs):
        d = ql[j] - psi[:, j] - borrow
        borrow = (d >> 63) & 1
        thr.append(d & _M32)
    ovf_p = torch.ones_like(psi0, dtype=torch.bool)
    for j in range(1, n_limbs):
        ovf_p = ovf_p & (thr[j] == 0)
    return psi0, psi_hi, psi_hi1, thr[0], ovf_p


def _paper_encrypt(words, consts):
    """(N, W) int64 payload words -> the compact ciphertext (c0 plane,
    selector plane): the sum's high limbs take only three per-channel
    values (Ψ_hi, Ψ_hi + 1, or 0 after the single subtract of q), so the
    selector (0, 1, 2) with c0 is a lossless recoding of the (W, L) limbs
    (see :func:`_paper_expand_ct`)."""
    psi0, _, _, thr0, ovf_p = consts
    s0 = words + psi0[:, None]
    carry = s0 > _M32
    ovf = ovf_p[:, None] & (words >= thr0[:, None])
    c0 = torch.where(ovf, words - thr0[:, None], s0 & _M32)
    sel = torch.where(ovf, 2, torch.where(carry, 1, 0)).to(torch.uint8)
    return c0, sel


def _paper_decrypt(c0, sel, consts):
    """Inverse of :func:`_paper_encrypt` from the compact wire alone."""
    psi0, _, _, thr0, _ = consts
    return torch.where(sel == 2, (c0 + thr0[:, None]) & _M32,
                       (c0 - psi0[:, None]) & _M32)


def _paper_expand_ct(c0, sel, consts):
    """Compact wire -> the full (N, W, L) ciphertext limbs (parity checks;
    never on the hot path)."""
    _, psi_hi, psi_hi1, _, _ = consts
    c_hi = torch.where((sel == 2)[..., None], 0,
                       torch.where((sel == 1)[..., None], psi_hi1[:, None, :],
                                   psi_hi[:, None, :]))
    return field.to_u32(torch.cat([c0[..., None], c_hi], dim=-1))


def _wire_stream_fast(words, material, n_limbs: int, return_ct: bool):
    """The narrow 3-limb stream wire: payload + u64 mask < 2^65, far below
    q, so the reduction is provably dead and limbs 3.. stay zero."""
    lo, hi = field.keystream_words_traced_batched(material, words.shape[1])
    lo, hi = field.to_i64(lo), field.to_i64(hi)
    s0 = words + lo
    c0 = s0 & _M32
    s1 = hi + (s0 >> 32)
    c1 = s1 & _M32
    c2 = s1 >> 32                     # 1 only when hi == 2^32-1 and a carry
    out = (c0 - lo) & _M32
    if not return_ct:
        return out, None
    ct = torch.stack([c0, c1, c2] + [torch.zeros_like(c0)] * (n_limbs - 3),
                     dim=-1)
    return out, field.to_u32(ct)


def _wire_paper_fast(words, material, q: int, n_limbs: int, return_ct: bool):
    consts = _paper_channel_consts(material, q, n_limbs)
    c0, sel = _paper_encrypt(words, consts)
    out = _paper_decrypt(c0, sel, consts)
    if not return_ct:
        return out, None
    return out, _paper_expand_ct(c0, sel, consts)


def _wire_general(words, material, q: int, mode: str, n_limbs: int,
                  use_kernel: bool, return_ct: bool):
    """The general wire over (N, W) 32-bit words; ``use_kernel`` picks the
    CUDA ``mask_add`` kernel or its plain version.  Returns the decrypted
    (N, W) words as ``int32`` bits (and the ciphertext limbs).  Each dead
    plane is dropped as soon as it is used: at the full qwen2-7b width one
    (N, W, L) plane is 9.3 GB."""
    from .ops import _limb_ready
    mask = _general_mask(material, mode, words.shape[1], n_limbs)
    ct = _limb_ready(field.embed_limbs(words, n_limbs), mask, q, use_kernel,
                     subtract=False)
    out = _limb_ready(ct, mask, q, use_kernel, subtract=True)
    del mask
    out = out.view(torch.int32)[..., 0].contiguous()
    return out, (ct if return_ct else None)


def wire_roundtrip(x, material, *, q: int, mode: str,
                   use_kernel: bool = False, return_ct: bool = False):
    """One wire round trip: encrypt ``x`` per channel, decrypt it again.
    ``x`` is (N, ...) float32, axis 0 the channel (worker) axis;
    ``material`` is (N, 8) PRF seed words (stream) or (N, L) Ψ limbs
    (paper).  ``use_kernel`` takes the general wire through the CUDA
    ``mask_add`` kernel (CUDA tensors only), else the fast wire.  Returns
    ``x`` bit-identically (the bits codec is lossless), plus the (N, W, L)
    ``torch.uint32`` ciphertext limbs when ``return_ct``.
    """
    if mode == "stream" and q.bit_length() <= 64:
        raise ValueError("fused stream wire needs a >64-bit modulus "
                         "(mask words are unreduced u64)")
    n_limbs = _n_limbs(q)
    shape = x.shape
    words = x.to(torch.float32).reshape(shape[0], -1).contiguous().view(
        torch.int32)
    material = field.as_u32_tensor(material, x.device)
    if use_kernel:
        out, ct = _wire_general(words, material, q, mode, n_limbs, True,
                                return_ct)
    else:
        w64 = field.to_i64(words)
        if mode == "stream":
            out, ct = _wire_stream_fast(w64, material, n_limbs, return_ct)
        else:
            out, ct = _wire_paper_fast(w64, material, q, n_limbs, return_ct)
        out = out.to(torch.int32)
    out = out.view(torch.float32).reshape(shape)
    return (out, ct) if return_ct else out


def encrypted_coded_matmul(weights, blocks, rhs, material_out, material_back,
                           *, q: int, mode: str, use_kernel: bool = False,
                           return_wire: bool = False):
    """The encrypted round body: encode -> wire-out -> worker products ->
    wire-back.

    weights (N, J); blocks (J, blk, d); rhs (d, n_out); ``material_*`` as in
    :func:`wire_roundtrip` -> (N, blk, n_out) float32 worker results, ready
    for the masked decode.  With ``use_kernel`` (CUDA tensors) it launches
    ``berrut_combine`` once (the encode), ``mask_add`` four times and
    ``coded_matmul`` once (identity weights: the shards are already coded).
    Without, it runs the ops of ``ref.coded_matmul`` in their order with the
    fast wires between, so its output is bit-identical to the plain round.
    ``return_wire`` also returns the out/back ciphertext limbs.
    """
    from .ops import berrut_combine, coded_matmul
    dev = blocks.device
    weights = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
    rhs = rhs.to(torch.float32)
    if use_kernel:
        coded = berrut_combine(weights, blocks.to(torch.float32),
                               force_kernel=True)
    else:
        flat = blocks.reshape(blocks.shape[0], -1).to(torch.float32)
        coded = torch.matmul(weights, flat)
        coded = coded.reshape((weights.shape[0],) + tuple(blocks.shape[1:]))

    def wire(x, material):
        out = wire_roundtrip(x, material, q=q, mode=mode,
                             use_kernel=use_kernel, return_ct=return_wire)
        return out if return_wire else (out, None)

    # wire out: each worker receives (and decrypts) its coded shard
    coded, ct_out = wire(coded, material_out)
    if use_kernel:
        eye = torch.eye(weights.shape[0], dtype=torch.float32, device=dev)
        results = coded_matmul(eye, coded, rhs, force_kernel=True)
    else:
        results = torch.matmul(coded, rhs)
    del coded
    # wire back: every worker's product returns encrypted (the straggler
    # slots are computed too; the virtual clock prices who actually ran)
    results, ct_back = wire(results, material_back)
    if return_wire:
        return results, ct_out, ct_back
    return results
