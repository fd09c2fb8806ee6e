"""Attention: GQA with qkv bias, qk-norm and RoPE (forward and decode).

Ports the GQA part of ``repro/models/attention.py`` (``init_attention``,
``_project_qkv``, ``attn_forward``, ``init_kv_cache``, ``_dus_seq``,
``_decode_positions``, ``attn_decode``).  Parameters keep the reference's
layouts: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d),
biases (H or KV, hd), qk-norm scales (hd,).  Each einsum of the reference
runs here as one matmul over the flattened head axes.

The full-sequence forward (train / prefill) goes through
``kernels.ops.flash_attention``: the hand-written CUDA flash kernel for
CUDA tensors, the dense ``ref.mha_reference`` for CPU tensors.  The
reference passes explicit positions to its blockwise XLA attention, but in
the forward they are always ``arange(S)`` for both queries and keys
(``transformer.py:307``, ``attention.py:254``), which is exactly what the
kernel's implicit positions compute.

Decode is one-token attention against a KV cache, the reference's plain
einsum softmax, at a scalar ``pos`` (uniform across the batch) or a
``(B,)`` tensor of per-slot positions (continuous batching).  The cache is
updated in place (the reference returns a new one), also when the leaf is
a view of a larger cache (the serve loop's bucket); ``attn_decode``
returns the same dict.  ``proj`` reroutes the q|k|v and output projections
(the coded serving path); everything else is shared with the plain path.

Not ported yet, and raising ``NotImplementedError``: cross-attention
(``kv=``, whisper), M-RoPE, the int8 KV cache and MLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (apply_rope, const_init, dense_init, dtype_of,
                     rms_normalize)

__all__ = ["init_attention", "attn_forward", "init_kv_cache", "attn_decode",
           "init_mla", "mla_forward", "mla_decode"]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: a later slice of "
                               "the port; see ROADMAP.md")


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


def _proj(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w.astype(cd)) as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(cd).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, use_rope: bool, matmul=None):
    """``matmul`` (optional) replaces only the three projections: the coded
    serve path runs them as one stacked coded site; bias, qk-norm and RoPE
    stay here either way."""
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
    itself takes the same positions implicitly.  ``force_kernel`` is
    ``kernels.ops.flash_attention``'s (None: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors).
    """
    if kv is not None:
        raise _later("cross-attention (kv=, whisper)")
    if mrope_positions is not None:
        raise _later("M-RoPE (mrope_positions=)")
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    q, k, v = _project_qkv(p, x, cfg, positions, use_rope)
    out = ops.flash_attention(q, k, v, causal=causal,
                              softcap=cfg.attn_logit_softcap,
                              force_kernel=force_kernel)
    return out.flatten(2) @ p["wo"].to(cd).flatten(0, 1)


# ---- decode ---------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    if cfg.kv_cache_dtype == "int8":
        raise _later("the int8 KV cache")
    shape = (batch, max_len, cfg.n_kv_heads_padded, cfg.head_dim_)
    dtype = dtype or dtype_of(cfg, "compute")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def attn_decode(p, x: torch.Tensor, cache: dict, pos, cfg: ModelConfig, *,
                use_rope: bool = True, proj=None):
    """One-token decode.  x (B, 1, d); ``pos`` the scalar current length,
    uniform across the batch, or (B,) per-slot positions (ragged
    continuous-batching decode).  ``proj`` (optional) = ``{"qkv": fn,
    "o": fn}`` overrides of the projection matmuls (the coded serve path);
    bias, qk-norm, RoPE, the cache write and the softmax are shared with
    the plain path.  Returns (y (B, 1, d), cache), the cache written in
    place at ``pos``."""
    cd = dtype_of(cfg, "compute")
    b = x.shape[0]
    proj = proj or {}
    positions = _decode_positions(b, pos, x.device)
    q, k_new, v_new = _project_qkv(p, x.to(cd), cfg, positions, use_rope,
                                   matmul=proj.get("qkv"))
    k = _dus_seq(cache["k"], k_new, pos)
    v = _dus_seq(cache["v"], v_new, pos)
    kv_len = k.shape[1]
    span = torch.arange(kv_len, device=x.device)[None, :]
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
    out = out.reshape(b, 1, -1).to(cd)
    if proj.get("o") is not None:
        return proj["o"](out), cache
    return out @ p["wo"].to(cd).reshape(-1, cfg.d_model), cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): a later slice
# --------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig):
    raise _later("MLA (deepseek-v2)")


def mla_forward(p, x, cfg: ModelConfig, positions, **_):
    raise _later("MLA (deepseek-v2)")


def mla_decode(p, x, cache, pos, cfg: ModelConfig, **_):
    raise _later("MLA (deepseek-v2)")
