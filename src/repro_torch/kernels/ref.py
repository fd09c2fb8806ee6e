"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Ports ``repro/kernels/ref.py`` (``berrut_combine``, ``coded_matmul``,
``mask_add``, ``encrypted_coded_matmul`` and ``mha_reference``), and adds
``flash_attention_bwd_reference``, the plain version of the flash
backward kernel (the reference's ``_flash_bwd``, XLA there), and the
float32 flash kernels' 3xTF32 arithmetic: ``tf32_split``,
``flash_f32_planes`` and ``flash_bwd_f32_planes`` (the plain versions of
the forward's and the backward's pre-passes), ``mha_3xtf32`` and
``flash_attention_bwd_3xtf32`` (plain emulations of the kernels, which
the tests hold against the JAX references; nothing on the main path calls
them).  The CPU
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
           "flash_attention_bwd_reference", "tf32_split", "flash_f32_planes",
           "mha_3xtf32", "flash_bwd_f32_planes", "flash_attention_bwd_3xtf32",
           "ATTN_CHUNK"]

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
                                  chunk: int = ATTN_CHUNK,
                                  acc=torch.float32) -> tuple:
    """The plain version of the flash backward kernel: dq, dk and dv of
    :func:`mha_reference` from its output ``out``, its ``lse`` (B, Sq, H)
    and the output's gradient ``dout``, in the inputs' dtypes (float64
    where ``acc`` is).

    Follows the reference's ``_flash_bwd`` (``models/attention.py:107``)
    chunk by chunk over ``chunk`` keys in ``acc`` (float32; float64 gives
    the tools' error yardstick): the probabilities ``exp(s - lse)`` are
    recomputed per chunk, ``delta = rowsum(dout * out)``, ``ds = p (dp -
    delta)`` (times ``1 - tanh^2`` under softcap), masked keys give 0; dq
    and dk carry the 1/sqrt(hd) scale.
    """
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, sq, kvh, g, hd).to(acc) * scale
    do = dout.reshape(b, sq, kvh, g, hd_v).to(acc)
    delta = (do * out.reshape(b, sq, kvh, g, hd_v).to(acc)).sum(-1)
    lse_g = lse.reshape(b, sq, kvh, g).to(acc)
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros(qg.shape, dtype=acc, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].to(acc)
        vb = v[:, c0:c0 + chunk].to(acc)
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
    wide = acc == torch.float64
    dq = (dq * scale).reshape(b, sq, h, hd).to(acc if wide else q.dtype)
    dk = torch.cat(dks, dim=1).to(acc if wide else k.dtype)
    dv = torch.cat(dvs, dim=1).to(acc if wide else v.dtype)
    return dq, dk, dv


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's 10 mantissa bits, to nearest
    with ties away from zero, as ``tf32_round`` in ``csrc/coded_matmul.cu``
    and ``csrc/flash_attention.cu``: the low 13 bits of the word become 0
    (infinities and NaNs pass unchanged)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    special = (u & 0x7F800000) == 0x7F800000
    r = torch.where(special, u, (u + 0x1000) & 0xFFFFE000)
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi), float32: the
    error-compensated split of the 3xTF32 products.  hi + lo is x to within
    2^-22 of |x| (|lo|'s own rounding)."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _f32_scale(hd: int) -> torch.Tensor:
    # the kernels' scale: 1/sqrt(hd) rounded to float32, applied in float32
    return torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)


def _product_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) +
            torch.einsum(eq, a_hi, b_hi))


# V^T's keys, within every group of 8, in the kernel's order: position i
# holds key _KEY_ORDER[i]
_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _key_order(n: int, device) -> torch.Tensor:
    """Positions 0..n-1 (n a multiple of 8) -> the index each holds in the
    kernels' order: within every 8, (0, 2, 4, 6, 1, 3, 5, 7)."""
    return torch.tensor([8 * (i // 8) + _KEY_ORDER[i % 8] for i in range(n)],
                        device=device)


def _rows_planes(x, s_pad, width, scale=None):
    """(B, S, heads, w) -> (B * heads, 2, s_pad, width): TF32 hi and lo of
    x (times ``scale``, in float32), zero-padded."""
    x = x.to(torch.float32)
    if scale is not None:
        x = x * scale.to(x.device)
    pad = torch.zeros((x.shape[0], s_pad, x.shape[2], width),
                      dtype=torch.float32, device=x.device)
    pad[:, :x.shape[1], :, :x.shape[3]] = x
    pad = pad.permute(0, 2, 1, 3).reshape(-1, s_pad, width)
    return torch.stack(tf32_split(pad), dim=1)


def _t_planes(x, s_pad, width, scale=None):
    """(B, S, heads, w) -> (B * heads, 2, width, s_pad): TF32 hi and lo of
    x (times ``scale``) transposed, the sequence of every 8 in the kernels'
    order, zero-padded."""
    rows = _rows_planes(x, s_pad, width, scale)
    return rows[:, :, _key_order(s_pad, x.device)].transpose(2, 3)


def flash_f32_planes(q, k, v, extents) -> tuple:
    """The plain version of the float32 flash forward's pre-pass
    (``kernels.flash_attention.f32_planes``): ``q * scale`` and k as (B *
    heads, 2, S_pad, hd_pad) TF32 hi and lo planes, v^T as (B * KV, 2,
    hdv_pad, Skv_pad) with keys in the kernel's order, zero-padded to
    ``extents`` = (Sq_pad, Skv_pad, hd_pad, hdv_pad)."""
    sq_pad, skv_pad, hdp, nv = extents
    hd = q.shape[3]
    return (_rows_planes(q, sq_pad, hdp, _f32_scale(hd)),
            _rows_planes(k, skv_pad, hdp), _t_planes(v, skv_pad, nv))


def flash_bwd_f32_planes(q, k, v, out, lse, dout, extents) -> tuple:
    """The plain version of the float32 flash backward's pre-pass
    (``kernels.flash_attention_bwd.bwd_f32_planes``), ``extents`` =
    (Sq_pad, Skv_pad, hd_pad, hdv_pad): ``lse2 = lse * log2(e)`` and
    ``delta = rowsum(dout * out)``, (B * H, Sq_pad) float32, zero past Sq;
    TF32 hi and lo rows planes of q * scale and dout (B * H, 2, Sq_pad,
    width) and of k and v (B * KV, 2, Skv_pad, width); transposed planes
    of q * scale and dout (B * H, 2, width, Sq_pad) and of k (B * KV, 2,
    hd_pad, Skv_pad), the sequence of every 8 in the kernels' order (0,
    2, 4, 6, 1, 3, 5, 7); every plane zero-padded."""
    sq_pad, skv_pad, hdp, nv = extents
    b, sq, h, hd = q.shape
    scale = _f32_scale(hd)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    lse2 = torch.zeros((b * h, sq_pad), dtype=torch.float32, device=q.device)
    delta = torch.zeros_like(lse2)
    lse2[:, :sq] = (lse.to(torch.float32) * log2e.to(q.device)).permute(
        0, 2, 1).reshape(b * h, sq)
    delta[:, :sq] = (dout.to(torch.float32) * out.to(torch.float32)).sum(
        -1).permute(0, 2, 1).reshape(b * h, sq)
    return (lse2, delta, _rows_planes(q, sq_pad, hdp, scale),
            _rows_planes(dout, sq_pad, nv), _rows_planes(k, skv_pad, hdp),
            _rows_planes(v, skv_pad, nv), _t_planes(q, sq_pad, hdp, scale),
            _t_planes(dout, sq_pad, nv), _t_planes(k, skv_pad, hdp))


def mha_3xtf32(q, k, v, *, causal: bool, softcap: float = 0.0,
               return_lse: bool = False, bkv: int = 32):
    """The float32 flash kernel's arithmetic in plain PyTorch (float32
    inputs): s = (q * scale) . k with q scaled in float32, each product
    ``lo . hi + hi . lo + hi . hi`` over :func:`tf32_split` (``lo . lo``
    dropped) with float32 sums; the softcap; the online softmax over tiles
    of ``bkv`` keys, its row state and row sums in float32; P split again
    for each tile's ``P . V``, added into the rescaled output; out = acc /
    max(l, 1e-30).  Shapes and masking as :func:`mha_reference`; with
    ``return_lse`` also each row's m + log(l).  For the tests: nothing on
    the main path calls it."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qs = q.to(torch.float32) * _f32_scale(hd).to(q.device)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    m = torch.full((b, h, sq), -1e30, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[3]), device=q.device)
    qi = torch.arange(sq, device=q.device)[:, None]
    for j0 in range(0, skv, bkv):
        j1 = min(j0 + bkv, skv)
        s = _product_3xtf32("bqhd,bkhd->bhqk", qs, kf[:, j0:j1])
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            s = s.masked_fill(torch.arange(j0, j1, device=q.device)[None, :]
                              > qi, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _product_3xtf32(
            "bhqk,bkhd->bhqd", p, vf[:, j0:j1])
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)
    if return_lse:
        lse = (m + torch.log(l.clamp_min(1e-30))).permute(0, 2, 1)
        return out.contiguous(), lse.contiguous()
    return out.contiguous()


def flash_attention_bwd_3xtf32(q, k, v, out, lse, dout, causal: bool,
                               softcap: float = 0.0, bq: int = 32,
                               bk: int = 32) -> tuple:
    """The float32 flash backward kernels' arithmetic in plain PyTorch
    (float32 inputs): s = (q * scale) . k with q scaled in float32 and dp =
    dout . v, each product ``lo . hi + hi . lo + hi . hi`` over
    :func:`tf32_split` (``lo . lo`` dropped) with float32 sums; the softcap;
    p = exp(s - lse) and ds = p (dp - delta) [(1 - tanh^2)] in float32 (at
    hd <= 96, where one warpgroup hands the other g = p [(1 - tanh^2)], ds
    = g (dp - delta)), masked pairs 0; dv = p^T dout and dk = ds^T (q *
    scale) summed over the G query heads and, within each, over tiles of
    ``bq`` queries, and dq = scale ds k over tiles of ``bk`` keys (at hd <=
    96 the even and the odd tiles apart, then added), each tile's 3xTF32
    product added in float32 in the kernels' order.  Shapes and masking as
    :func:`flash_attention_bwd_reference`, whose inputs it takes.  For the
    tests: nothing on the main path calls it."""
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    dev = q.device
    scale = _f32_scale(hd).to(dev)
    qs = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    do = dout.to(torch.float32)
    delta = (do * out.to(torch.float32)).sum(-1).permute(0, 2, 1)
    s = _product_3xtf32("bqhd,bkhd->bhqk", qs, kf)
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    valid = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        valid = (torch.arange(skv, device=dev)[None, :] <=
                 torch.arange(sq, device=dev)[:, None])
    zero = torch.zeros((), device=dev)
    p = torch.where(valid, torch.exp(s - lse.to(torch.float32).permute(
        0, 2, 1)[..., None]), zero)
    dp = _product_3xtf32("bqhd,bkhd->bhqk", do, vf)
    paired = hd <= 96           # the kernels' two-warpgroup passes
    if paired:
        gp = p * (1.0 - t * t) if softcap else p
        ds = gp * (dp - delta[..., None])
    else:
        ds = p * (dp - delta[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
    ds = torch.where(valid, ds, zero)
    dk = torch.zeros((b, skv, kvh, hd), device=dev)
    dv = torch.zeros((b, skv, kvh, hd_v), device=dev)
    for gi in range(g):
        heads = [kv * g + gi for kv in range(kvh)]   # head gi of each group
        for q0 in range(0, sq, bq):
            rows = slice(q0, q0 + bq)
            dv = dv + _product_3xtf32("bhqk,bqhd->bkhd", p[:, heads, rows],
                                      do[:, rows][:, :, heads])
            dk = dk + _product_3xtf32("bhqk,bqhd->bkhd", ds[:, heads, rows],
                                      qs[:, rows][:, :, heads])
    halves = [torch.zeros((b, sq, h, hd), device=dev) for _ in range(2)]
    for n, j0 in enumerate(range(0, skv, bk)):
        cols = slice(j0, j0 + bk)
        i = n % 2 if paired else 0
        halves[i] = halves[i] + _product_3xtf32(
            "bhqk,bkhd->bqhd", ds[..., cols], kf[:, cols])
    return (halves[0] + halves[1]) * scale, dk, dv
