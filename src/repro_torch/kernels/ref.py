"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Ports ``repro/kernels/ref.py`` (``berrut_combine``, ``coded_matmul``,
``mask_add``, ``encrypted_coded_matmul`` and ``mha_reference``).  The CPU
tests hold these against the JAX package, and ``chip_smoke.py`` holds each
hand-written CUDA kernel against them on the card.  The float versions
accumulate in float32 and return the blocks' dtype.  A float32 product on the card is full IEEE
float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False
(PyTorch's default).  The limb versions compute in int64 and are bit-exact.
"""

from __future__ import annotations

import torch

__all__ = ["berrut_combine", "coded_matmul", "mask_add",
           "encrypted_coded_matmul", "mha_reference"]


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


def mask_add(payload, mask, q_limbs, *, subtract: bool = False) -> torch.Tensor:
    """MEA-ECC mask add/sub: (payload ± mask) mod q over 32-bit limb planes
    ``(..., L)``, ``mask`` broadcast against ``payload`` — the carry chain
    and single conditional subtract of ``crypto.field`` (int64 arithmetic,
    bit-exact with the reference's uint32 chains).  Returns
    ``torch.uint32``."""
    from ..crypto import field
    op = field.sub_mod if subtract else field.add_mod
    return op(field.as_u32_tensor(payload), field.as_u32_tensor(mask),
              q_limbs)


def encrypted_coded_matmul(weights, blocks, rhs, material_out, material_back,
                           *, q: int, mode: str) -> torch.Tensor:
    """The encrypted round computed naively: encode, run every wire through
    the *general* limb cipher (bits embed -> full-width ``add_mod`` mask add
    -> ``sub_mod``), the worker products, and the wire back.  The same
    torch ops in the same order as :func:`coded_matmul`, so the output is
    bit-identical to it: the cipher round trips are lossless.

    weights (N, J); blocks (J, blk, d); rhs (d, n_out); ``material_*`` are
    per-channel (N, 8) PRF seed words (stream) or (N, L) Ψ limbs (paper).
    """
    from ..crypto import field
    n_limbs = max(-(-q.bit_length() // 32), 1)
    q_limbs = field.int_to_limbs(q, n_limbs)

    def wire(x, material):
        words = x.reshape(x.shape[0], -1).to(torch.float32).contiguous()
        limbs = field.embed_limbs(words.view(torch.int32), n_limbs)
        material = field.as_u32_tensor(material, x.device)
        if mode == "stream":
            mask = torch.stack([field.stream_mask_traced(
                s, words.shape[1], n_limbs).view(torch.int32)
                for s in material.view(torch.int32)]).view(torch.uint32)
        else:
            mask = material[:, None, :]
        ct = field.add_mod(limbs, mask, q_limbs)
        out = field.sub_mod(ct, mask, q_limbs).view(torch.int32)[..., 0]
        out = out.contiguous()
        return out.view(torch.int32).view(torch.float32).reshape(x.shape)

    flat = blocks.reshape(blocks.shape[0], -1).to(torch.float32)
    coded = torch.matmul(weights.to(torch.float32), flat)
    coded = coded.reshape((weights.shape[0],) + tuple(blocks.shape[1:]))
    coded = wire(coded, material_out)
    out = torch.matmul(coded, rhs.to(torch.float32))
    return wire(out, material_back).to(blocks.dtype)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, softcap: float = 0.0) -> torch.Tensor:
    """Dense multi-head attention oracle: the plain version of the flash
    attention kernel.  q (B,Sq,H,hd) k/v (B,Skv,KV,hd) -> (B,Sq,H,hd).

    GQA by grouping q as (B,Sq,KV,G,hd): query head h reads kv head h // G.
    The (Sq, Skv) scores and probabilities are materialised in float32; the
    output is cast to q's dtype.  Causal masks key j of query i when j > i,
    both positions counted from 0.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).to(torch.float32) / (hd ** 0.5)
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.to(torch.float32))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        keep = (torch.arange(skv, device=q.device)[None, :] <=
                torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~keep[None, :, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
