"""Attention: GQA with qkv bias, qk-norm, RoPE or M-RoPE, cross-attention,
and DeepSeek-V2's MLA (forward and decode).

Ports ``repro/models/attention.py``: the GQA module (``init_attention``,
``_project_qkv``, ``attn_forward``, ``project_kv``, ``init_kv_cache``,
``_dus_seq``, ``_decode_positions``, ``attn_decode``) and multi-head latent
attention (``init_mla``, ``_mla_qc``, ``mla_forward``, ``init_mla_cache``,
``mla_decode``).  Parameters keep the reference's layouts: ``wq`` (d, H,
hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), biases (H or KV, hd),
qk-norm scales (hd,).  Each einsum of the reference
runs here as one matmul over the flattened head axes.

The full-sequence forward (train / prefill) goes through
``kernels.ops.flash_attention``: the hand-written CUDA flash kernel for
CUDA tensors, the dense ``ref.mha_reference`` for CPU tensors.  The
reference passes explicit positions to its blockwise XLA attention, but in
the forward they are always ``arange(S)`` for both queries and keys
(``transformer.py:307``, ``attention.py:254``), which is exactly what the
kernel's implicit positions compute.  With ``cfg.mrope_sections`` and
``mrope_positions`` (3, B, S) given, q and k take Qwen2-VL's M-RoPE
(``layers.apply_mrope``) in place of RoPE; the attention's own positions
stay implicit, as in the reference, whose blockwise attention masks by
``positions`` whatever rotated q and k.

Cross-attention (whisper's decoder, ``attn_forward(kv=(k, v,
kv_positions))``) projects only q (and its bias) from x and attends,
unmasked, over k and v precomputed from the encoder output by
``project_kv``.  The reference's ``kv_positions`` only mask padded keys
(position -1) in its blockwise attention; the encoder output has none,
so the kernel's full (non-causal) attention over all Skv keys computes
the same thing and the positions are not read.

Decode is one-token attention against a KV cache, the reference's plain
einsum softmax, at a scalar ``pos`` (uniform across the batch) or a
``(B,)`` tensor of per-slot positions (continuous batching).  The cache is
updated in place (the reference returns a new one), also when the leaf is
a view of a larger cache (the serve loop's bucket); ``attn_decode``
returns the same dict.  ``proj`` reroutes the q|k|v and output projections
(the coded serving path); everything else is shared with the plain path.
``attn_decode(cross_kv={"k", "v"})`` is the decoder's cross-attention
step: q from x, every cached encoder row valid, no cache write.

MLA keeps the reference's leaves: ``wq`` (d, H, nope + rope), ``w_dkv``
(d, lora + rope), ``kv_norm`` (lora,), ``w_uk`` (lora, H, nope), ``w_uv``
(lora, H, v), ``wo`` (H, v, d).  Its forward expands the latent into
per-head k = [k_nope | k_rope broadcast over heads] and v, so the flash
kernel takes q . k over nope + rope (192 at full width) against a v of
``v_head_dim`` (128): the reference's blockwise attention does the same
(its TPU twin is the Pallas flash kernel).  Its decode is the reference's
absorbed form: scores in the lora latent space against a cache of ``ckv``
(B, L, lora) and ``kpe`` (B, L, rope), scale 1/sqrt(nope + rope), written
in place like the GQA cache; ``proj`` reroutes the wq|w_dkv and wo
projections, while the per-head latent maps ``w_uk``/``w_uv`` stay here.

With ``cfg.kv_cache_dtype == "int8"`` the GQA cache is the reference's
quantized one: int8 ``k``/``v`` payloads and float16 ``k_scale``/
``v_scale`` per (token, kv head).  The decode quantizes the new row
(``_quantize_kv``: amax / 127, round half to even as ``jnp.round``,
clipped to +-127), writes payload and scale in place, and attends over the
dequantized cache in float32.

The full-sequence forward trains on the card through the flash forward and
backward kernels (``kernels.ops.flash_attention``).  On a device mesh
(``dist.sharding``) the specs below place the parameters and caches:
heads over ``model`` (k/v heads only when ``model`` divides them), the
cache's batch over ``data`` and its sequence over ``model``.  A decode
against a sequence-sharded cache is flash decoding
(``_seq_sharded_attention``): each rank attends over its slice of the
cache, and the partial softmaxes combine by an all-reduce of their maxima
and one of their sums.  An MLA cache decodes the same way over its
latent scores (``_seq_sharded_mla``), and both take a scalar ``pos`` or
(B,) per-slot positions (each rank writes the rows whose position falls
in its slice and masks per batch row).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..dist import collectives
from ..dist.sharding import P, is_distributed
from ..kernels import ops
from .layers import (apply_mrope, apply_rope, const_init, dense_init,
                     dtype_of, rms_normalize)

__all__ = ["init_attention", "attention_specs", "attn_forward", "project_kv",
           "init_kv_cache", "kv_cache_specs", "attn_decode", "init_mla",
           "mla_specs", "mla_forward", "init_mla_cache", "mla_cache_specs",
           "mla_decode"]


# --------------------------------------------------------------------------
# GQA attention module
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator,
                   cfg: ModelConfig) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, kv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    pd = dtype_of(cfg)
    p = {"wq": dense_init(gen, (d, hq, hd), pd),
         "wk": dense_init(gen, (d, kv, hd), pd),
         "wv": dense_init(gen, (d, kv, hd), pd),
         "wo": dense_init(gen, (hq, hd, d), pd)}
    if cfg.qkv_bias:
        p["bq"] = const_init(gen, (hq, hd), 0.0, pd)
        p["bk"] = const_init(gen, (kv, hd), 0.0, pd)
        p["bv"] = const_init(gen, (kv, hd), 0.0, pd)
    if cfg.qk_norm:
        p["q_norm"] = const_init(gen, (hd,), 1.0, pd)
        p["k_norm"] = const_init(gen, (hd,), 1.0, pd)
    return nn.ParameterDict(p)


def attention_specs(cfg: ModelConfig) -> dict:
    tp = cfg.pad_heads_to
    kv_ax = "model" if (tp > 1 and cfg.n_kv_heads_padded % tp == 0) else None
    p = {"wq": P(None, "model", None), "wk": P(None, kv_ax, None),
         "wv": P(None, kv_ax, None), "wo": P("model", None, None)}
    if cfg.qkv_bias:
        p["bq"] = P("model", None)
        p["bk"] = P(kv_ax, None)
        p["bv"] = P(kv_ax, None)
    if cfg.qk_norm:
        p["q_norm"] = P(None)
        p["k_norm"] = P(None)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w.astype(cd)) as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(cd).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The query projection (+ bias) alone: cross-attention's."""
    cd = dtype_of(cfg, "compute")
    q = _proj(x.to(cd), p["wq"], cd)
    return q + p["bq"].to(cd) if cfg.qkv_bias else q


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, use_rope: bool,
                 mrope_positions=None, matmul=None):
    """``matmul`` (optional) replaces only the three projections: the coded
    serve path runs them as one stacked coded site; bias, qk-norm and RoPE
    (M-RoPE where the config has sections and ``mrope_positions`` (3, B,
    S) is given) stay here either way."""
    cd = dtype_of(cfg, "compute")
    if matmul is not None:
        q, k, v = matmul(x)
    else:
        q, k, v = _proj(x, p["wq"], cd), _proj(x, p["wk"], cd), \
            _proj(x, p["wv"], cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rms_normalize(q) * p["q_norm"].to(cd)
        k = rms_normalize(k) * p["k_norm"].to(cd)
    if use_rope and cfg.rope_theta > 0:
        if cfg.mrope_sections and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, causal: bool = True,
                 use_rope: bool = True, mrope_positions=None, kv=None,
                 force_kernel: bool | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  x (B, S, d) -> (B, S, d).

    ``positions`` (B, S) must be ``arange(S)`` in every row, as the
    reference's forward passes them: they drive RoPE, and the attention
    itself takes the same positions implicitly.  ``mrope_positions`` (3,
    B, S) drive M-RoPE instead where the config has sections.  ``kv`` =
    (k (B, Skv, KV, hd), v, kv_positions) makes it cross-attention: q
    alone is projected from x, and attends to all Skv keys (pass
    ``causal=False``, as the reference's encoder-decoder does).
    ``force_kernel`` is ``kernels.ops.flash_attention``'s (None: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors).
    """
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions, use_rope,
                               mrope_positions)
    else:
        q = _project_q(p, x, cfg)
        k, v = kv[0], kv[1]
    out = ops.flash_attention(q, k, v, causal=causal,
                              softcap=cfg.attn_logit_softcap,
                              force_kernel=force_kernel)
    return out.flatten(2) @ p["wo"].to(cd).flatten(0, 1)


def project_kv(p, x: torch.Tensor, cfg: ModelConfig, positions=None,
               use_rope: bool = False):
    """Cross-attention's k and v (B, S, KV, hd) from the encoder output x
    (B, S, d), computed once per forward (or per decode cache): the k|v
    projections and their biases, and RoPE on k only where asked (never
    for whisper, whose ``rope_theta`` is 0)."""
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    k, v = _proj(x, p["wk"], cd), _proj(x, p["wv"], cd)
    if cfg.qkv_bias:
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if use_rope and cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---- decode ---------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads_padded, cfg.head_dim_)
    if cfg.kv_cache_dtype == "int8":
        # int8 payload + per-(token, kv head) float16 scales: about half
        # a bf16 cache's bytes (the decode reads it into a float32 copy)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device)}
    dtype = dtype or dtype_of(cfg, "compute")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs(cfg: ModelConfig) -> dict:
    # batch over data, sequence over model: the flash-decoding layout
    p = {"k": P("data", "model", None, None),
         "v": P("data", "model", None, None)}
    if cfg.kv_cache_dtype == "int8":
        p["k_scale"] = P("data", "model", None)
        p["v_scale"] = P("data", "model", None)
    return p


def _quantize_kv(x: torch.Tensor):
    """(B, 1, KV, hd) -> (int8 payload, float16 scale (B, 1, KV))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(payload: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """An int8 cache leaf and its scales -> float32 (B, L, KV, hd)."""
    return payload.to(torch.float32) * scale.to(torch.float32)[..., None]


def _per_slot(pos) -> bool:
    return torch.is_tensor(pos) and pos.dim() > 0


def _dus_seq(cache_leaf: torch.Tensor, new: torch.Tensor,
             pos) -> torch.Tensor:
    """Sequence-axis cache write of ``new`` (B, 1, ...) in place, at a
    scalar ``pos`` or at per-slot positions ``pos`` (B,); returns the
    cache leaf (which may be a view of a larger cache)."""
    new = new[:, 0].to(cache_leaf.dtype)
    if _per_slot(pos):
        rows = torch.arange(cache_leaf.shape[0], device=cache_leaf.device)
        cache_leaf[rows, pos.to(device=cache_leaf.device,
                                dtype=torch.long)] = new
    else:
        cache_leaf[:, int(pos)] = new
    return cache_leaf


def _decode_positions(b: int, pos, device) -> torch.Tensor:
    """(B, 1) int32 rope positions from a scalar or per-slot ``pos``."""
    if _per_slot(pos):
        return pos.to(device=device, dtype=torch.int32).reshape(b, 1)
    return torch.full((b, 1), int(pos), dtype=torch.int32, device=device)


def attn_decode(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *,
                use_rope: bool = True, mrope_positions=None, cross_kv=None,
                proj=None):
    """One-token decode.  x (B, 1, d); ``pos`` the scalar current length,
    uniform across the batch, or (B,) per-slot positions (ragged
    continuous-batching decode).  ``mrope_positions`` (3, B, 1) drive
    M-RoPE where the config has sections (None: RoPE at ``pos``, which is
    M-RoPE with three equal streams).  ``proj`` (optional) = ``{"qkv":
    fn, "o": fn}`` overrides of the projection matmuls (the coded serve
    path); bias, qk-norm, RoPE, the cache write and the softmax are shared
    with the plain path.  Returns (y (B, 1, d), cache), the cache written
    in place at ``pos``.

    ``cross_kv`` = ``{"k", "v"}`` (B, L, KV, hd) makes it cross-attention:
    q (+ bias) from x over all L cached rows, no write; ``cache`` is
    returned as given (the reference passes None)."""
    cd = dtype_of(cfg, "compute")
    b = x.shape[0]
    proj = proj or {}
    positions = _decode_positions(b, pos, x.device)
    if cross_kv is not None:
        q = _project_q(p, x, cfg)
        k, v = cross_kv["k"], cross_kv["v"]
        valid = torch.ones((b, k.shape[1]), dtype=torch.bool,
                           device=x.device)
    else:
        q, k_new, v_new = _project_qkv(p, x.to(cd), cfg, positions,
                                       use_rope, mrope_positions,
                                       matmul=proj.get("qkv"))
        if is_distributed(cache["k"]):
            out = _seq_sharded_attention(q, k_new, v_new, cache, pos, cfg)
            return _decode_out(p, out, cfg, proj), cache
        if cfg.kv_cache_dtype == "int8":
            k8, ks = _quantize_kv(k_new)
            v8, vs = _quantize_kv(v_new)
            _dus_seq(cache["k_scale"], ks, pos)
            _dus_seq(cache["v_scale"], vs, pos)
            k = _dequantize_kv(_dus_seq(cache["k"], k8, pos),
                               cache["k_scale"])
            v = _dequantize_kv(_dus_seq(cache["v"], v8, pos),
                               cache["v_scale"])
        else:
            k = _dus_seq(cache["k"], k_new, pos)
            v = _dus_seq(cache["v"], v_new, pos)
        span = torch.arange(k.shape[1], device=x.device)[None, :]
        valid = span <= (positions if _per_slot(pos) else int(pos))

    kvh, hd = k.shape[2], q.shape[-1]
    g = q.shape[2] // kvh
    qg = q.reshape(b, kvh, g, hd).to(torch.float32) / (hd ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32))
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return _decode_out(p, out.reshape(b, 1, -1).to(cd), cfg, proj), cache


def _seq_dim(leaf) -> int:
    """The mesh dim that shards the cache's sequence (tensor dim 1)."""
    from torch.distributed.tensor import Shard
    for mdim, pl in enumerate(leaf.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            return mdim
    raise ValueError(f"the cache's sequence dim is not sharded: "
                     f"{leaf.placements}")


class _Slice:
    """This rank's slice of a sequence-sharded cache leaf (``leaf``): the
    placements with the sequence's mesh dim replicated (``row_pl``), the
    local batch rows and positions, each local row's decode position
    (``pos`` a scalar or (B,) per-slot), where this rank writes the new
    token (``write``: the local position or None for a scalar ``pos``;
    (rows, clamped local positions, rows inside the slice) per slot) and
    the valid mask (local batch, local positions)."""

    def __init__(self, leaf, pos):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = mesh = leaf.device_mesh
        self.sdim = sdim = _seq_dim(leaf)
        self.row_pl = tuple(Replicate() if m == sdim else pl
                            for m, pl in enumerate(leaf.placements))
        b_l, self.l_loc = leaf.to_local().shape[:2]
        coord = mesh.get_coordinate()
        self.offset = coord[sdim] * self.l_loc
        dev = leaf.to_local().device
        if _per_slot(pos):
            row = 0                 # this rank's batch block, row-major
            for m, pl in enumerate(leaf.placements):
                if isinstance(pl, Shard) and pl.dim == 0:
                    row = row * mesh.size(m) + coord[m]
            p = pos.to(device=dev, dtype=torch.long)[row * b_l:
                                                     (row + 1) * b_l]
            at = p - self.offset
            # (rows, local positions clamped, rows that hold their token)
            self.write = (torch.arange(b_l, device=dev),
                          at.clamp(0, self.l_loc - 1),
                          (at >= 0) & (at < self.l_loc))
        else:
            p = torch.full((b_l,), int(pos), dtype=torch.long, device=dev)
            at = int(pos) - self.offset
            self.write = at if 0 <= at < self.l_loc else None
        span = self.offset + torch.arange(self.l_loc, device=dev)
        self.valid = span[None, :] <= p[:, None]

    def local(self, t):
        """DTensor ``t`` with the sequence's mesh dim replicated, as its
        local tensor."""
        return t.redistribute(self.mesh, self.row_pl).to_local()

    def put(self, leaf: torch.Tensor, new: torch.Tensor) -> None:
        """Write ``new`` (local B, ...) rows into the local cache leaf: at
        one position (a scalar ``pos``), or each row at its own where its
        position falls in the slice (the others keep their value; no
        data-dependent shape, so it runs on meta tensors too)."""
        new = new.to(leaf.dtype)
        if isinstance(self.write, tuple):
            rows, at, inside = self.write
            keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
            leaf[rows, at] = torch.where(keep, new, leaf[rows, at])
        elif self.write is not None:
            leaf[:, self.write] = new

    def combine(self, s, valid, values, width: int):
        """The softmax over the whole cache of this rank's float32 scores
        ``s`` (..., L_loc), masked by ``valid``, against ``values``:
        ``values(e)`` is this rank's exp-weighted sum, (..., width).
        m = max_r m_r (an all-reduce), then one all-reduce of [o | l]."""
        s = s.masked_fill(~valid, -1e30)
        m_r = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m_r) * valid
        l_r = e.sum(dim=-1, keepdim=True)
        o_r = values(e)
        group = self.mesh.get_group(self.sdim)
        m = m_r.clone()
        collectives.all_reduce(m, "max", group)
        scale = torch.exp(m_r - m)
        both = torch.cat([o_r * scale, l_r * scale], dim=-1)
        collectives.all_reduce(both, "sum", group)
        return both[..., :width] / both[..., width:]

    def placed(self, out):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(out, self.mesh, self.row_pl,
                                  run_check=False)


def _seq_sharded_attention(q, k_new, v_new, cache: dict, pos,
                           cfg: ModelConfig):
    """One-token GQA attention against a cache whose sequence dim is
    sharded over a mesh dim (``kv_cache_specs``: batch over ``data``,
    sequence over ``model``), written in place.

    q (B, 1, H, hd), k_new / v_new (B, 1, KV, hd): DTensors on the cache's
    mesh, any placements; ``pos`` a scalar or (B,) per-slot positions.
    Each rank gathers the new token's heads, writes each local batch row
    whose position falls in its slice (an int8 cache quantized by
    ``_quantize_kv``), and computes its slice's scores (float32, scale
    1/sqrt(hd), softcap, positions past each row's ``pos`` masked), their
    max m_r, the sum l_r of exp(s - m_r) and o_r = sum exp(s - m_r) v.
    Then m = max_r m_r (an all-reduce) and out = sum_r e^(m_r - m) o_r /
    sum_r e^(m_r - m) l_r (one all-reduce of [o | l]): the softmax over
    the whole cache.  Returns out (B, 1, H hd) in the compute dtype, a
    DTensor placed as the cache's batch and replicated over the sequence
    dim's mesh axis."""
    sl = _Slice(cache["k"], pos)
    q_l, k_l, v_l = sl.local(q), sl.local(k_new), sl.local(v_new)
    b_l = q_l.shape[0]
    local = {key: leaf_.to_local() for key, leaf_ in cache.items()}
    if cfg.kv_cache_dtype == "int8":
        k8, ks = _quantize_kv(k_l)
        v8, vs = _quantize_kv(v_l)
        for key, val in (("k", k8), ("v", v8), ("k_scale", ks),
                         ("v_scale", vs)):
            sl.put(local[key], val[:, 0])
        k = _dequantize_kv(local["k"], local["k_scale"])
        v = _dequantize_kv(local["v"], local["v_scale"])
    else:
        sl.put(local["k"], k_l[:, 0])
        sl.put(local["v"], v_l[:, 0])
        k, v = local["k"], local["v"]
    kvh, hd = k.shape[2], q_l.shape[-1]
    g = q_l.shape[2] // kvh
    f32 = torch.float32
    qg = q_l.reshape(b_l, kvh, g, hd).to(f32) / (hd ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(f32))
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    out = sl.combine(s, sl.valid[:, None, None, :], lambda e: torch.einsum(
        "bkgs,bskd->bkgd", e, v.to(f32)), hd)
    out = out.reshape(b_l, 1, -1).to(dtype_of(cfg, "compute"))
    return sl.placed(out)


def _decode_out(p, out: torch.Tensor, cfg: ModelConfig, proj: dict):
    """The decode's output projection of out (B, 1, H hd)."""
    if proj.get("o") is not None:
        return proj["o"](out)
    cd = dtype_of(cfg, "compute")
    return out @ p["wo"].to(cd).reshape(-1, cfg.d_model)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): multi-head latent attention
# --------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, h = cfg.d_model, cfg.n_heads_padded
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vh, lora = cfg.v_head_dim, cfg.kv_lora_rank
    pd = dtype_of(cfg)
    return nn.ParameterDict({
        "wq": dense_init(gen, (d, h, nope + rope_d), pd),
        "w_dkv": dense_init(gen, (d, lora + rope_d), pd),
        "kv_norm": const_init(gen, (lora,), 1.0, pd),
        "w_uk": dense_init(gen, (lora, h, nope), pd),
        "w_uv": dense_init(gen, (lora, h, vh), pd),
        "wo": dense_init(gen, (h, vh, d), pd)})


def mla_specs(cfg: ModelConfig) -> dict:
    return {"wq": P(None, "model", None), "w_dkv": P(None, None),
            "kv_norm": P(None), "w_uk": P(None, "model", None),
            "w_uv": P(None, "model", None), "wo": P("model", None, None)}


def _mla_qc(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
            matmul=None):
    """The shared q and compressed-kv projections -> (q_nope (B, S, H,
    nope), q_rope (B, S, H, rope), ckv (B, S, lora), k_rope (B, S, 1,
    rope)).  ``matmul`` (optional) replaces only the two projections (wq
    and w_dkv share x, so the coded serve path runs them as one site) and
    returns (q, dkv); RoPE and the latent norm stay here either way."""
    cd = dtype_of(cfg, "compute")
    nope, lora = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    if matmul is not None:
        q, dkv = matmul(x)
    else:
        q, dkv = _proj(x, p["wq"], cd), x @ p["w_dkv"].to(cd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rms_normalize(dkv[..., :lora]) * p["kv_norm"].to(cd)
    k_rope = apply_rope(dkv[..., lora:][:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, causal: bool = True,
                force_kernel: bool | None = None, **_) -> torch.Tensor:
    """Full-sequence MLA (train / prefill).  x (B, S, d) -> (B, S, d).
    The latent is expanded to per-head k (nope + rope wide) and v
    (``v_head_dim`` wide) for ``kernels.ops.flash_attention``;
    ``positions`` must be ``arange(S)`` per row, as in ``attn_forward``."""
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    q_nope, q_rope, ckv, k_rope = _mla_qc(p, x, cfg, positions)
    k_nope = _proj(ckv, p["w_uk"], cd)          # bsl,lhk->bshk
    v = _proj(ckv, p["w_uv"], cd)
    k = torch.cat([k_nope, k_rope.expand(-1, -1, k_nope.shape[2], -1)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.flash_attention(q, k, v, causal=causal,
                              force_kernel=force_kernel)
    return out.flatten(2) @ p["wo"].to(cd).flatten(0, 1)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None) -> dict:
    dtype = dtype or dtype_of(cfg, "compute")
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                               dtype=dtype, device=device)}


def mla_cache_specs(cfg: ModelConfig) -> dict:
    return {"ckv": P("data", "model", None), "kpe": P("data", "model", None)}


def mla_decode(p, x: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
               proj=None, **_):
    """Absorbed-form one-token MLA decode.  x (B, 1, d); ``pos`` a scalar
    or (B,) per-slot positions.

    q_eff[b, h, l] = sum_k q_nope[b, h, k] w_uk[l, h, k]; s = (q_eff . ckv
    + q_rope . kpe) / sqrt(nope + rope); o_latent = softmax(s) . ckv; out
    = o_latent . w_uv, then wo.  The scores and the latent sum are float32,
    the latent maps run in the compute dtype, as the reference.  ``proj``
    = ``{"qkv": fn, "o": fn}`` reroutes the wq|w_dkv projection (``fn(x)
    -> (q (B, 1, H, nope + rope), dkv (B, 1, lora + rope))``) and wo
    (``fn(o (B, H * v)) -> (B, d)``).  Returns (y (B, 1, d), cache), the
    cache written in place at ``pos``."""
    cd = dtype_of(cfg, "compute")
    b = x.shape[0]
    x = x.to(cd)
    proj = proj or {}
    positions = _decode_positions(b, pos, x.device)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qc(p, x, cfg, positions,
                                                  matmul=proj.get("qkv"))
    if is_distributed(cache["ckv"]):
        o_lat = _seq_sharded_mla(p, q_nope, q_rope, ckv_new, k_rope_new,
                                 cache, pos, cfg)
        return _mla_out(p, o_lat, b, cfg, proj), cache
    ckv = _dus_seq(cache["ckv"], ckv_new, pos)
    kpe = _dus_seq(cache["kpe"], k_rope_new[:, 0], pos)

    f32 = torch.float32
    q_eff = torch.einsum("bshk,lhk->bhl", q_nope, p["w_uk"].to(cd))
    s = (torch.einsum("bhl,bsl->bhs", q_eff.to(f32), ckv.to(f32))
         + torch.einsum("bshr,btr->bht", q_rope.to(f32), kpe.to(f32))) \
        / (cfg.head_dim_ ** 0.5)
    span = torch.arange(ckv.shape[1], device=x.device)[None, None, :]
    valid = span <= (positions[:, :, None] if _per_slot(pos) else int(pos))
    w = torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", w, ckv.to(f32)).to(cd)
    return _mla_out(p, o_lat, b, cfg, proj), cache


def _mla_out(p, o_lat, b: int, cfg: ModelConfig, proj: dict):
    """The latent output (B, H, lora) through ``w_uv`` and ``wo`` ->
    (B, 1, d)."""
    cd = dtype_of(cfg, "compute")
    o = torch.einsum("bhl,lhk->bhk", o_lat, p["w_uv"].to(cd)).reshape(b, -1)
    if proj.get("o") is not None:
        y = proj["o"](o)
    else:
        y = o @ p["wo"].to(cd).reshape(-1, cfg.d_model)
    return y[:, None, :]


def _seq_sharded_mla(p, q_nope, q_rope, ckv_new, k_rope_new, cache: dict,
                     pos, cfg: ModelConfig):
    """The absorbed MLA decode against a cache whose sequence is sharded
    (``mla_cache_specs``: ``ckv``/``kpe`` batch over ``data``, sequence
    over ``model``): the two-collective softmax of
    ``_seq_sharded_attention`` over the latent scores.  Each rank writes
    its rows of ``ckv``/``kpe``, scores q_eff . ckv + q_rope . kpe over
    its slice, and forms m_r, l_r and its latent sum o_r; one all-reduce
    takes the max and one [o | l].  Returns the latent output (B, H,
    lora), a DTensor placed as the cache's batch, in the compute dtype."""
    cd = dtype_of(cfg, "compute")
    f32 = torch.float32
    sl = _Slice(cache["ckv"], pos)
    q_eff = torch.einsum("bshk,lhk->bhl", q_nope, p["w_uk"].to(cd))
    q_eff, q_r = sl.local(q_eff), sl.local(q_rope)
    local = {key: leaf.to_local() for key, leaf in cache.items()}
    sl.put(local["ckv"], sl.local(ckv_new)[:, 0])
    sl.put(local["kpe"], sl.local(k_rope_new)[:, 0, 0])
    ckv, kpe = local["ckv"].to(f32), local["kpe"].to(f32)
    s = (torch.einsum("bhl,bsl->bhs", q_eff.to(f32), ckv)
         + torch.einsum("bshr,btr->bht", q_r.to(f32), kpe)) \
        / (cfg.head_dim_ ** 0.5)
    o_lat = sl.combine(s, sl.valid[:, None, :], lambda e: torch.einsum(
        "bhs,bsl->bhl", e, ckv), ckv.shape[-1])
    return sl.placed(o_lat.to(cd))
