"""Attention-free sequence mixers: RWKV6 (Finch) time and channel mix, and
the Mamba (S6) selective SSM in Jamba's flavour (dt/B/C rms norms).

Ports ``repro/models/ssm.py``: ``init_rwkv_block``, ``init_rwkv_state``,
``_rwkv_projections``, ``_wkv_step``, ``_group_norm``, ``rwkv_time_mix``,
``rwkv_channel_mix``, ``rwkv_decode_step``, ``rwkv_channel_mix_decode``;
``_mamba_dims``, ``init_mamba_block``, ``init_mamba_state``, ``_rms``,
``_mamba_bcdt``, ``_ssm_step``, ``mamba_forward``, ``mamba_decode_step``.
``rwkv_block_specs``, ``rwkv_state_specs``, ``mamba_block_specs`` and
``mamba_state_specs`` give each leaf's PartitionSpec, as the reference.

Parameters keep the reference's leaves and shapes (``nn.ParameterDict``s,
float32 master weights cast to the compute dtype where used); the
recurrent states are float32, as the reference's default.  Every function
is pure, as the reference's: it returns a new state dict, and
``transformer.DecoderLayer.decode`` writes it into the decode cache in
place.

The full-sequence recurrences run through ``layers.chunked_scan``, one
eager step per token: plain PyTorch, as the reference's ``lax.scan`` is
plain XLA (its docstring: "in lieu of a fused TPU scan kernel"), so there
is no Pallas kernel to port here.  On the card the scans are
launch-bound: a handful of small launches per token and layer.

Two spellings differ from the reference's, with the same values:

* Mamba's causal depthwise conv (``lax.conv_general_dilated`` with "WIO"
  weights and ``feature_group_count=din``) is ``F.conv1d(..., groups=din)``
  with the weights permuted to (din, 1, cw); both are cross-correlations,
  so the kernel is not flipped.  The decode runs the same conv over its
  (cw)-token window, where the reference writes the window's einsum.
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns x
  itself above 20, where the two differ by under 2e-9.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..dist.sharding import P
from .layers import chunked_scan, const_init, dense_init, dtype_of

__all__ = ["init_rwkv_block", "rwkv_block_specs", "init_rwkv_state",
           "rwkv_state_specs", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_decode_step", "rwkv_channel_mix_decode", "init_mamba_block",
           "mamba_block_specs", "init_mamba_state", "mamba_state_specs",
           "mamba_forward", "mamba_decode_step"]

SCAN_CHUNK = 128
RWKV_LORA = 64
F32 = torch.float32


def _uniform(gen: torch.Generator, shape, dtype) -> nn.Parameter:
    """U[0, 1) on the generator's device (``jax.random.uniform``)."""
    return nn.Parameter(torch.rand(tuple(shape), generator=gen,
                                   device=gen.device).to(dtype))


# ==========================================================================
# RWKV6
# ==========================================================================

def _rwkv_heads(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def init_rwkv_block(gen: torch.Generator,
                    cfg: ModelConfig) -> nn.ParameterDict:
    d, ff = cfg.d_model, cfg.d_ff
    h, hd = _rwkv_heads(cfg)
    pd = dtype_of(cfg)
    return nn.ParameterDict({
        # time mix
        "mu": _uniform(gen, (5, d), pd),              # r, k, v, w, g lerp
        "w0": const_init(gen, (d,), 0.0, pd),
        "w_lora_a": dense_init(gen, (d, RWKV_LORA), pd),
        "w_lora_b": const_init(gen, (RWKV_LORA, d), 0.0, pd),
        "wr": dense_init(gen, (d, d), pd),
        "wk": dense_init(gen, (d, d), pd),
        "wv": dense_init(gen, (d, d), pd),
        "wg": dense_init(gen, (d, d), pd),
        "wo": dense_init(gen, (d, d), pd),
        "u": dense_init(gen, (h, hd), pd, scale=0.5),  # per-head bonus
        "ln_x_scale": const_init(gen, (d,), 1.0, pd),
        "ln_x_bias": const_init(gen, (d,), 0.0, pd),
        # channel mix
        "cm_mu": _uniform(gen, (2, d), pd),           # k, r
        "cm_wk": dense_init(gen, (d, ff), pd),
        "cm_wv": dense_init(gen, (ff, d), pd),
        "cm_wr": dense_init(gen, (d, d), pd)})


def rwkv_block_specs(cfg: ModelConfig) -> dict:
    return {
        "mu": P(None, None), "w0": P("model"),
        "w_lora_a": P(None, None), "w_lora_b": P(None, "model"),
        "wr": P(None, "model"), "wk": P(None, "model"),
        "wv": P(None, "model"), "wg": P(None, "model"),
        "wo": P("model", None),
        "u": P("model", None),
        "ln_x_scale": P("model"), "ln_x_bias": P("model"),
        "cm_mu": P(None, None),
        "cm_wk": P(None, "model"), "cm_wv": P("model", None),
        "cm_wr": P(None, "model"),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None,
                    dtype=F32) -> dict:
    h, hd = _rwkv_heads(cfg)
    d = cfg.d_model
    return {"tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, hd, hd), dtype=dtype,
                               device=device)}


def rwkv_state_specs(cfg: ModelConfig) -> dict:
    return {"tm_x": P("data", "model"), "cm_x": P("data", "model"),
            "wkv": P("data", "model", None, None)}


def _rwkv_projections(p, x: torch.Tensor, x_prev: torch.Tensor,
                      cfg: ModelConfig):
    """Token-shift lerp and projections.  x, x_prev (..., d) in the
    compute dtype -> r, k, v, g (compute dtype), w (float32): the Finch
    decay exp(-exp(clip(w0 + lora(xw), -10, 10))), computed in float32."""
    cd = dtype_of(cfg, "compute")
    mu = p["mu"].to(cd)
    xm = [x + (x_prev - x) * mu[i] for i in range(5)]     # r, k, v, w, g
    r = xm[0] @ p["wr"].to(cd)
    k = xm[1] @ p["wk"].to(cd)
    v = xm[2] @ p["wv"].to(cd)
    lora = torch.tanh(xm[3] @ p["w_lora_a"].to(cd)) @ p["w_lora_b"].to(cd)
    w = torch.exp(-torch.exp((p["w0"].to(F32) + lora.to(F32))
                             .clamp(-10, 10)))
    g = F.silu(xm[4] @ p["wg"].to(cd))
    return r, k, v, w, g


def _wkv_step(state: torch.Tensor, inp):
    """state (B, H, hd, hd) float32; inp: r, k, v, w (B, H, hd), u (H, hd).
    out = r . (state + u * k v^T); new state = w * state + k v^T."""
    r, k, v, w, u = inp
    kv = k[..., :, None] * v[..., None, :]                # outer product
    bonus = torch.addcmul(state, u[None, :, :, None], kv)
    out = (r[..., None, :] @ bonus)[..., 0, :]
    return torch.addcmul(kv, w[..., None], state), out


def _group_norm(x: torch.Tensor, scale, bias, n_heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head groupnorm over (..., H * hd) in float32, with the
    population variance (as ``jnp.var``), cast back to x's dtype."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).to(F32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale + bias).to(x.dtype)


def _shifted(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The token shift: ``last`` (B, d), cast to x's dtype, in front of
    x[:, :-1]."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def rwkv_time_mix(p, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), new state)."""
    cd = dtype_of(cfg, "compute")
    b, s, d = x.shape
    h, hd = _rwkv_heads(cfg)
    x = x.to(cd)
    r, k, v, w, g = _rwkv_projections(p, x, _shifted(x, state["tm_x"]), cfg)
    u = p["u"].to(F32)
    # time-first float32 operands, contiguous so each step reads one block
    xs = tuple(a.reshape(b, s, h, hd).to(F32).movedim(1, 0).contiguous()
               for a in (r, k, v, w))

    def step(st, inp):
        return _wkv_step(st, inp + (u,))

    new_wkv, ys = chunked_scan(step, state["wkv"].to(F32), xs,
                               min(SCAN_CHUNK, s))
    out = ys.movedim(0, 1).reshape(b, s, d).to(cd)
    out = _group_norm(out, p["ln_x_scale"].to(cd), p["ln_x_bias"].to(cd), h)
    out = (out * g) @ p["wo"].to(cd)
    new_state = dict(state, tm_x=x[:, -1].to(state["tm_x"].dtype),
                     wkv=new_wkv.to(state["wkv"].dtype))
    return out, new_state


def _channel_mix(p, x, x_prev, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg, "compute")
    mu = p["cm_mu"].to(cd)
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    k = torch.square(F.relu(xk @ p["cm_wk"].to(cd)))
    return torch.sigmoid(xr @ p["cm_wr"].to(cd)) * (k @ p["cm_wv"].to(cd))


def rwkv_channel_mix(p, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), new state)."""
    x = x.to(dtype_of(cfg, "compute"))
    out = _channel_mix(p, x, _shifted(x, state["cm_x"]), cfg)
    return out, dict(state, cm_x=x[:, -1].to(state["cm_x"].dtype))


def rwkv_decode_step(p, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """Single-token time mix.  x (B, 1, d) -> (out (B, 1, d), new state)."""
    cd = dtype_of(cfg, "compute")
    b, _, d = x.shape
    h, hd = _rwkv_heads(cfg)
    xt = x[:, 0].to(cd)
    r, k, v, w, g = _rwkv_projections(p, xt, state["tm_x"].to(cd), cfg)
    new_wkv, out = _wkv_step(
        state["wkv"].to(F32),
        tuple(a.reshape(b, h, hd).to(F32) for a in (r, k, v, w))
        + (p["u"].to(F32),))
    out = out.reshape(b, d).to(cd)
    out = _group_norm(out, p["ln_x_scale"].to(cd), p["ln_x_bias"].to(cd), h)
    out = (out * g) @ p["wo"].to(cd)
    return out[:, None], dict(state, tm_x=xt.to(state["tm_x"].dtype),
                              wkv=new_wkv.to(state["wkv"].dtype))


def rwkv_channel_mix_decode(p, x: torch.Tensor, state: dict,
                            cfg: ModelConfig):
    """Single-token channel mix.  x (B, 1, d) -> (out (B, 1, d), new
    state)."""
    cd = dtype_of(cfg, "compute")
    xt = x[:, 0].to(cd)
    out = _channel_mix(p, xt, state["cm_x"].to(cd), cfg)
    return out[:, None], dict(state, cm_x=xt.to(state["cm_x"].dtype))


# ==========================================================================
# Mamba (S6, Jamba flavour with dt/B/C norms)
# ==========================================================================

def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(din, dt_rank) = (expand d, max(d // 16, 1))."""
    return cfg.expand * cfg.d_model, max(cfg.d_model // 16, 1)


def init_mamba_block(gen: torch.Generator,
                     cfg: ModelConfig) -> nn.ParameterDict:
    d, n, cw = cfg.d_model, cfg.d_state, cfg.conv_width
    din, dtr = _mamba_dims(cfg)
    pd = dtype_of(cfg)
    a_log = torch.log(torch.arange(1, n + 1, dtype=F32,
                                   device=gen.device)).expand(din, n)
    return nn.ParameterDict({
        "w_in": dense_init(gen, (d, 2, din), pd),
        "conv_w": dense_init(gen, (cw, 1, din), pd, scale=0.5),
        "conv_b": const_init(gen, (din,), 0.0, pd),
        "x_proj": dense_init(gen, (din, dtr + 2 * n), pd),
        "dt_w": dense_init(gen, (dtr, din), pd),
        "dt_b": const_init(gen, (din,), -4.6, pd),    # softplus^-1(0.01)
        "A_log": nn.Parameter(a_log.contiguous().to(pd)),
        "D": const_init(gen, (din,), 1.0, pd),
        "dt_norm": const_init(gen, (dtr,), 1.0, pd),
        "b_norm": const_init(gen, (n,), 1.0, pd),
        "c_norm": const_init(gen, (n,), 1.0, pd),
        "w_out": dense_init(gen, (din, d), pd)})


def mamba_block_specs(cfg: ModelConfig) -> dict:
    return {
        "w_in": P(None, None, "model"),
        "conv_w": P(None, None, "model"), "conv_b": P("model"),
        "x_proj": P("model", None),
        "dt_w": P(None, "model"), "dt_b": P("model"),
        "A_log": P("model", None), "D": P("model"),
        "dt_norm": P(None), "b_norm": P(None), "c_norm": P(None),
        "w_out": P("model", None),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, device=None,
                     dtype=F32) -> dict:
    din, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, din),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, din, cfg.d_state), dtype=dtype,
                               device=device)}


def mamba_state_specs(cfg: ModelConfig) -> dict:
    return {"conv": P("data", None, "model"), "ssm": P("data", "model", None)}


def _rms(x: torch.Tensor, scale, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
            * scale.to(F32)).to(x.dtype)


def _mamba_bcdt(p, x1: torch.Tensor, cfg: ModelConfig):
    """x1 (..., din) -> dt (..., din), B (..., n), C (..., n), all
    float32."""
    cd = dtype_of(cfg, "compute")
    _, dtr = _mamba_dims(cfg)
    n = cfg.d_state
    bcdt = x1 @ p["x_proj"].to(cd)
    dt_in = _rms(bcdt[..., :dtr], p["dt_norm"])
    bb = _rms(bcdt[..., dtr:dtr + n], p["b_norm"]).to(F32)
    cc = _rms(bcdt[..., dtr + n:], p["c_norm"]).to(F32)
    dt = F.softplus((dt_in @ p["dt_w"].to(cd)).to(F32) + p["dt_b"].to(F32))
    return dt, bb, cc


def _ssm_step(p_a: torch.Tensor, p_d: torch.Tensor, state: torch.Tensor,
              inp):
    """state (B, din, n) float32; inp: x1 (B, din), dt (B, din), B (B, n),
    C (B, n).  new = exp(dt A) state + (dt x1) B; y = new . C + D x1."""
    x1, dt, bb, cc = inp
    decay = torch.exp(dt[..., None] * p_a[None])
    new = torch.addcmul(decay * state, (dt * x1)[..., None],
                        bb[:, None, :])
    y = torch.addcmul((new @ cc[..., None])[..., 0], p_d[None], x1)
    return new, y


def _causal_conv(x_pad: torch.Tensor, conv_w, conv_b,
                 cd: torch.dtype) -> torch.Tensor:
    """silu(depthwise conv + bias) of x_pad (B, cw - 1 + S, din) ->
    (B, S, din): ``conv_general_dilated`` with "WIO" weights (cw, 1, din)
    and ``feature_group_count=din``."""
    weight = conv_w.to(cd).permute(2, 1, 0)               # (din, 1, cw)
    y = F.conv1d(x_pad.transpose(1, 2), weight, groups=x_pad.shape[-1])
    return F.silu(y.transpose(1, 2) + conv_b.to(cd))


def mamba_forward(p, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), new state)."""
    cd = dtype_of(cfg, "compute")
    b, s, d = x.shape
    din, _ = _mamba_dims(cfg)
    cw = cfg.conv_width
    xz = (x.to(cd) @ p["w_in"].to(cd).reshape(d, 2 * din)) \
        .unflatten(-1, (2, din))                          # bsd,dtc->bstc
    x1, z = xz[:, :, 0], xz[:, :, 1]
    x_pad = torch.cat([state["conv"].to(cd), x1], dim=1)
    x1c = _causal_conv(x_pad, p["conv_w"], p["conv_b"], cd)
    dt, bb, cc = _mamba_bcdt(p, x1c, cfg)
    a = -torch.exp(p["A_log"].to(F32))
    p_d = p["D"].to(F32)

    def step(st, inp):
        return _ssm_step(a, p_d, st, inp)

    xs = tuple(t.movedim(1, 0).contiguous()
               for t in (x1c.to(F32), dt, bb, cc))
    new_ssm, ys = chunked_scan(step, state["ssm"].to(F32), xs,
                               min(SCAN_CHUNK, s))
    y = ys.movedim(0, 1).to(cd) * F.silu(z)
    out = y @ p["w_out"].to(cd)
    new_state = {"conv": x_pad[:, -(cw - 1):].to(state["conv"].dtype),
                 "ssm": new_ssm.to(state["ssm"].dtype)}
    return out, new_state


def mamba_decode_step(p, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """Single-token Mamba step.  x (B, 1, d) -> (out (B, 1, d), new
    state)."""
    cd = dtype_of(cfg, "compute")
    d = x.shape[-1]
    din, _ = _mamba_dims(cfg)
    xz = (x[:, 0].to(cd) @ p["w_in"].to(cd).reshape(d, 2 * din)) \
        .unflatten(-1, (2, din))                          # bd,dtc->btc
    x1, z = xz[:, 0], xz[:, 1]
    window = torch.cat([state["conv"].to(cd), x1[:, None]], dim=1)
    x1c = _causal_conv(window, p["conv_w"], p["conv_b"], cd)[:, 0]
    dt, bb, cc = _mamba_bcdt(p, x1c, cfg)
    new_ssm, y = _ssm_step(-torch.exp(p["A_log"].to(F32)), p["D"].to(F32),
                           state["ssm"].to(F32), (x1c.to(F32), dt, bb, cc))
    out = (y.to(cd) * F.silu(z)) @ p["w_out"].to(cd)
    new_state = {"conv": window[:, 1:].to(state["conv"].dtype),
                 "ssm": new_ssm.to(state["ssm"].dtype)}
    return out[:, None], new_state
