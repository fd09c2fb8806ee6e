"""Shared model building blocks: plain functions on tensors, with
parameters held in ``nn.ParameterDict``s keyed as the reference's nested
dicts.

Ports ``repro/models/layers.py``: ``dtype_of``, ``dense_init``,
``init_norm``/``apply_norm``, ``rms_normalize``, ``init_ffn``/``apply_ffn``,
``init_embedding``/``embed``/``unembed``, the NeoX RoPE, Qwen2-VL's
M-RoPE (``apply_mrope``), whisper's ``sinusoidal_positions`` and
``chunked_scan`` (the SSM mixers' recurrence); ``remat`` stands in for
the reference's ``jax.checkpoint`` of its scanned layer bodies.  Every
``init_*`` has a sibling ``*_specs`` giving each leaf's PartitionSpec
(``dist.sharding.P``) on a (data, model) mesh, as the reference's.

Conventions, as in the reference: activations flow in
``cfg.compute_dtype`` (bf16 by default); parameters and norm math are
float32; every weight is cast to the compute dtype where it is used
(``w.to(cd)``), so the master weights stay float32.  Random init draws from
an explicit ``torch.Generator`` with the reference's distributions; the
numbers differ from ``jax.random``'s, so parity tests carry the reference's
parameters across (``models.convert``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..dist.sharding import P

__all__ = ["dtype_of", "dense_init", "const_init", "init_norm", "norm_specs",
           "apply_norm", "rms_normalize", "init_ffn", "ffn_specs",
           "apply_ffn", "init_embedding", "embedding_specs", "embed",
           "unembed", "apply_rope", "apply_mrope",
           "sinusoidal_positions", "chunked_scan", "remat"]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dtype_of(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if kind == "param"
                   else cfg.compute_dtype)


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> nn.Parameter:
    """N(0, 1) * scale on the generator's device; ``scale`` defaults to
    1/sqrt(fan_in) with fan_in = shape[0], as the reference."""
    scale = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
    if gen.device.type == "meta":
        return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                        device="meta"))
    w = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return nn.Parameter(w.mul_(scale).to(dtype))


def const_init(gen: torch.Generator, shape, value: float,
               dtype) -> nn.Parameter:
    """A constant (biases 0, norm scales 1) on the generator's device."""
    return nn.Parameter(torch.full(tuple(shape), value, dtype=dtype,
                                   device=gen.device))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d = cfg.d_model
    p = {"scale": const_init(gen, (d,), 1.0, dtype_of(cfg))}
    if cfg.norm_type == "layernorm":
        p["bias"] = const_init(gen, (d,), 0.0, dtype_of(cfg))
    return nn.ParameterDict(p)


def norm_specs(cfg: ModelConfig) -> dict:
    p = {"scale": P(None)}
    if cfg.norm_type == "layernorm":
        p["bias"] = P(None)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm or layernorm in float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].to(torch.float32) + \
            p["bias"].to(torch.float32)
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * \
            p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free rmsnorm (qk-norm); eps is 1e-6, not ``cfg.norm_eps``."""
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, ff = cfg.d_model, cfg.d_ff
    pd = dtype_of(cfg)
    if cfg.activation == "swiglu":
        return nn.ParameterDict({"w_gate": dense_init(gen, (d, ff), pd),
                                 "w_up": dense_init(gen, (d, ff), pd),
                                 "w_down": dense_init(gen, (ff, d), pd)})
    return nn.ParameterDict({"w_up": dense_init(gen, (d, ff), pd),
                             "w_down": dense_init(gen, (ff, d), pd)})


def ffn_specs(cfg: ModelConfig) -> dict:
    if cfg.activation == "swiglu":
        return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                "w_down": P("model", None)}
    return {"w_up": P(None, "model"), "w_down": P("model", None)}


def apply_ffn(p, x: torch.Tensor, cfg: ModelConfig, *, matmul_up=None,
              matmul_down=None) -> torch.Tensor:
    """swiglu, gelu (the tanh approximation, as ``jax.nn.gelu``) or
    relu_sq, in the compute dtype.  ``matmul_up``/``matmul_down``
    (optional) replace only the projections: the coded serve path runs
    gate|up stacked as one coded site and down as another; the activation
    stays here either way.  ``matmul_up(x)`` returns ``(gate, up)`` for
    swiglu, else ``up``."""
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    if cfg.activation == "swiglu":
        if matmul_up is not None:
            g, u = matmul_up(x)
        else:
            g, u = x @ p["w_gate"].to(cd), x @ p["w_up"].to(cd)
        h = F.silu(g) * u
    else:
        u = matmul_up(x) if matmul_up is not None else x @ p["w_up"].to(cd)
        if cfg.activation == "relu_sq":
            h = torch.square(F.relu(u))
        else:
            h = F.gelu(u, approximate="tanh")
    if matmul_down is not None:
        return matmul_down(h)
    return h @ p["w_down"].to(cd)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator,
                   cfg: ModelConfig) -> nn.ParameterDict:
    pd = dtype_of(cfg)
    p = {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), pd,
                             scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    return nn.ParameterDict(p)


def embedding_specs(cfg: ModelConfig) -> dict:
    p = {"table": P("model", None)}          # vocab-sharded
    if not cfg.tie_embeddings:
        p["unembed"] = P(None, "model")      # logits sharded over vocab
    return p


def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gather from the float32 table, then cast to the compute dtype.  A
    vocab-sharded table (a DTensor on a mesh) gathers through
    ``F.embedding``, whose sharding rule reads each rank's rows into a
    masked partial sum (indexing would re-shard the table first)."""
    table = p["table"]
    if type(table).__name__ == "DTensor":
        return F.embedding(tokens, table).to(dtype_of(cfg, "compute"))
    return table[tokens].to(dtype_of(cfg, "compute"))


def unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg, "compute")
    w = p["table"].T if cfg.tie_embeddings else p["unembed"]
    logits = x.to(cd) @ w.to(cd)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# --------------------------------------------------------------------------
# positions: RoPE, M-RoPE, sinusoidal
# --------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2) in float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    return positions[..., None].to(torch.float32) * inv_freq


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., hd) with angles (..., hd/2): GPT-NeoX half rotation, float32
    math, cast back to x's dtype."""
    xf = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c, s = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S)."""
    angles = _rope_angles(positions, x.shape[-1], theta)      # (B, S, hd/2)
    return _rotate(x, angles[..., None, :])                   # broadcast heads


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections, theta: float) -> torch.Tensor:
    """Qwen2-VL's M-RoPE.  x (B, S, H, hd); positions3 (3, B, S), the
    temporal, height and width streams; ``sections`` sum to hd/2: frequency
    band i of section j takes its angle from stream j.  Three equal
    streams give ``apply_rope``'s result bit for bit."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"hd/2 = {half}")
    streams = _rope_angles(positions3, x.shape[-1], theta)  # (3, B, S, half)
    pieces, start = [], 0
    for i, sec in enumerate(sections):
        pieces.append(streams[i, ..., start:start + sec])
        start += sec
    angles = torch.cat(pieces, dim=-1)                      # (B, S, half)
    return _rotate(x, angles[..., None, :])


def sinusoidal_positions(n: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(n, d) absolute position table: float32 angles pos / 10000^(2i/d),
    sin over the first d/2 columns and cos over the rest, cast to
    ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / 10000.0 ** (2.0 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).to(dtype)


# --------------------------------------------------------------------------
# the SSM mixers' scan
# --------------------------------------------------------------------------

def chunked_scan(step_fn, init_state: torch.Tensor, xs: tuple,
                 chunk_size: int):
    """``scan(step_fn)`` over time: ``step_fn(state, x_t) -> (state, y_t)``
    with ``x_t`` the tuple of every ``xs`` tensor's row t (leading time
    axis S).  Returns (the final state, the y_t stacked on a leading
    axis).

    The reference splits S into chunks of ``chunk_size`` so that its
    backward (``jax.checkpoint``) stores only the chunk boundaries' states.
    Inference stores no states, so the port steps once per token over all
    S in one loop, calling ``step_fn`` in the reference's order.  It keeps
    the reference's refusal of an S that ``chunk_size`` does not divide
    (its callers pad)."""
    s = xs[0].shape[0]
    if s % chunk_size:
        raise ValueError(f"time axis {s} not divisible by chunk {chunk_size}")
    state, ys = init_state, []
    for t in range(s):
        state, y = step_fn(state, tuple(a[t] for a in xs))
        ys.append(y)
    return state, torch.stack(ys)


def remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under per-call recomputation when
    ``cfg.remat`` is set and grad is enabled: the reference checkpoints its
    scanned layer bodies (``jax.checkpoint``); here each call runs under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which
    keeps only the call's inputs and runs ``fn`` once more in the backward.
    Under ``torch.no_grad()`` or ``torch.inference_mode()`` nothing
    changes.  Side effects of ``fn`` happen twice under recomputation (the
    kernels' launch counters count both forwards); ``fn`` must make its
    other side effects once itself.  No random draw runs in a layer, so
    the RNG state is not saved."""
    if cfg.remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)
