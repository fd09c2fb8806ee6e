"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Ports ``repro/kernels/ref.py`` (``berrut_combine``, ``coded_matmul``,
``mask_add``, ``encrypted_coded_matmul`` and ``mha_reference``), and adds
``flash_attention_bwd_reference``, the plain version of the flash
backward kernel (the reference's ``_flash_bwd``, XLA there).  The CPU
tests hold these against the JAX package, and ``chip_smoke.py`` holds each
hand-written CUDA kernel against them on the card.  The float versions
accumulate in float32 and return the blocks' dtype.  A float32 product on the card is full IEEE
float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False
(PyTorch's default).  The limb versions compute in int64 and are bit-exact.
"""

from __future__ import annotations

import torch

__all__ = ["berrut_combine", "coded_matmul", "mask_add",
           "encrypted_coded_matmul", "mha_reference",
           "flash_attention_bwd_reference", "ATTN_CHUNK"]

ATTN_CHUNK = 512   # the reference's KV chunk (models/attention.py)


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
                  causal: bool, softcap: float = 0.0,
                  return_lse: bool = False):
    """Dense multi-head attention oracle: the plain version of the flash
    attention kernel.  q (B,Sq,H,hd) k (B,Skv,KV,hd) v (B,Skv,KV,hd_v) ->
    (B,Sq,H,hd_v), scaled by 1/sqrt(hd) over the q . k width, as the
    reference's blockwise attention.  ``return_lse`` also returns each
    row's log-sum-exp of the scaled (soft-capped, masked) scores, (B, Sq,
    H) float32, natural log: the reference's ``_flash_fwd_core`` residual
    and the backward's input.

    GQA by grouping q as (B,Sq,KV,G,hd): query head h reads kv head h // G.
    The (Sq, Skv) scores and probabilities are materialised in float32; the
    output is cast to q's dtype.  Causal masks key j of query i when j > i,
    both positions counted from 0.  Differentiable by autograd: on the CPU
    the model trains through it.
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
    out = out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(b, sq, h)
    return out


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal: bool,
                                  softcap: float = 0.0,
                                  chunk: int = ATTN_CHUNK) -> tuple:
    """The plain version of the flash backward kernel: dq, dk and dv of
    :func:`mha_reference` from its output ``out``, its ``lse`` (B, Sq, H)
    and the output's gradient ``dout``, in the inputs' dtypes.

    Follows the reference's ``_flash_bwd`` (``models/attention.py:107``)
    chunk by chunk over ``chunk`` keys in float32: the probabilities
    ``exp(s - lse)`` are recomputed per chunk, ``delta = rowsum(dout *
    out)``, ``ds = p (dp - delta)`` (times ``1 - tanh^2`` under softcap),
    masked keys give 0; dq and dk carry the 1/sqrt(hd) scale.
    """
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, sq, kvh, g, hd).to(torch.float32) * scale
    do = dout.reshape(b, sq, kvh, g, hd_v).to(torch.float32)
    delta = (do * out.reshape(b, sq, kvh, g, hd_v).to(torch.float32)).sum(-1)
    lse_g = lse.reshape(b, sq, kvh, g).to(torch.float32)
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].to(torch.float32)
        vb = v[:, c0:c0 + chunk].to(torch.float32)
        s_raw = torch.einsum("bqkgd,bckd->bqkgc", qg, kb)
        s = softcap * torch.tanh(s_raw / softcap) if softcap else s_raw
        k_pos = torch.arange(c0, c0 + kb.shape[1], device=q.device)
        valid = torch.ones((sq, kb.shape[1]), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid = k_pos[None, :] <= q_pos[:, None]
        valid = valid[None, :, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        p = torch.exp(s - lse_g[..., None])
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, do))
        dp = torch.einsum("bqkgd,bckd->bqkgc", do, vb)
        ds = p * (dp - delta[..., None])
        if softcap:
            ds = ds * (1.0 - torch.square(torch.tanh(s_raw / softcap)))
        ds = torch.where(valid, ds, torch.zeros_like(ds))
        dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, kb)
        dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, qg))
    dq = (dq * scale).reshape(b, sq, h, hd).to(q.dtype)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq, dk, dv
