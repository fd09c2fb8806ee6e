"""Mixture-of-Experts FFN: capacity routing for the forward, all experts
dense for the decode.

Ports ``repro/models/moe.py`` (``init_moe``, ``_router``, ``_shared_ffn``,
``_expert_apply``, ``moe_ffn``, ``moe_ffn_decode``).  Parameters keep the
reference's leaves: ``router`` (d, E), ``w_gate``/``w_up`` (E, d, ff),
``w_down`` (E, ff, d) and, with shared experts, ``shared.w_gate``/
``shared.w_up`` (d, E_s ff), ``shared.w_down`` (E_s ff, d); ``moe_specs``
places the experts over ``model``, and ``moe_ffn`` pins its expert
buckets there (``shard_hint``, inert on one device), as the reference.

The router runs in float32 (the package never turns TF32 on): softmax,
top-k (``torch.topk``, sorted, as ``lax.top_k``), renormalised weights,
and the Switch load-balance and z losses.

``moe_ffn`` routes each sequence against a capacity ``cap = pad_to(max(
int(S k / E capacity_factor), 4), 4)``: a (token, choice)'s position in
its expert is the exclusive count of earlier choices of that expert in
(token, choice) order, and a choice at or past ``cap`` is dropped into the
dump slot ``E cap`` and adds nothing, as in the reference.  Both moves are
gathers here, so the forward gives the same bits on every run:

* dispatch: each of the E cap slots reads the token that fills it (or a
  zero row); the reference scatters masked token rows into the slots;
* combine: each token reads its k slots' expert outputs back and sums
  them weighted by its router weights, in choice order.  The reference
  scales each slot by its weight and scatter-adds the slots into their
  tokens; with an atomic ``index_add_`` of k rows per token the bfloat16
  sum would change from run to run.  So the sum order (and, in bfloat16,
  where it rounds) differs from the reference's scatter; the float32
  results agree to rounding.

The expert products are ``torch.bmm`` over the (E, B cap, d) buckets, as
the reference leaves its einsums to XLA outside any Pallas kernel.
``moe_ffn_decode`` computes every expert on every token and combines them
with the router weights, as the reference (with B k >= E every expert is
hit anyway).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, pad_to
from ..dist.sharding import P, shard_hint
from .layers import dense_init, dtype_of

__all__ = ["init_moe", "moe_specs", "moe_ffn", "moe_ffn_decode", "capacity"]


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    pd = dtype_of(cfg)
    p = {"router": dense_init(gen, (d, e), pd, scale=0.02)}
    if cfg.activation == "swiglu":
        p["w_gate"] = dense_init(gen, (e, d, ff), pd)
    p["w_up"] = dense_init(gen, (e, d, ff), pd)
    p["w_down"] = dense_init(gen, (e, ff, d), pd)
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        p["shared"] = nn.ParameterDict({
            "w_gate": dense_init(gen, (d, sf), pd),
            "w_up": dense_init(gen, (d, sf), pd),
            "w_down": dense_init(gen, (sf, d), pd)})
    return nn.ParameterDict(p)


def moe_specs(cfg: ModelConfig) -> dict:
    p = {"router": P(None, None)}
    if cfg.activation == "swiglu":
        p["w_gate"] = P("model", None, None)
    p["w_up"] = P("model", None, None)
    p["w_down"] = P("model", None, None)
    if cfg.n_shared_experts:
        p["shared"] = {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                       "w_down": P("model", None)}
    return p


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert and sequence in ``moe_ffn``."""
    return pad_to(max(int(seq * cfg.top_k / cfg.n_experts
                          * cfg.capacity_factor), 4), 4)


def _router(p, x: torch.Tensor, cfg: ModelConfig):
    """x (..., d) -> (weights (..., k) float32, idx (..., k), lb, z)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.reshape(-1, cfg.n_experts).mean(dim=0)
    ce = F.one_hot(idx.reshape(-1, cfg.top_k), cfg.n_experts).sum(1) \
        .to(torch.float32).mean(dim=0)
    lb_loss = cfg.n_experts * (me * ce).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return w, idx, lb_loss, z_loss


def _shared_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg, "compute")
    sp = p["shared"]
    h = F.silu(x @ sp["w_gate"].to(cd)) * (x @ sp["w_up"].to(cd))
    return h @ sp["w_down"].to(cd)


def _expert_apply(p, xb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xb (E, M, d) -> (E, M, d) through each expert's FFN."""
    cd = dtype_of(cfg, "compute")
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(xb, p["w_gate"].to(cd))) * \
            torch.bmm(xb, p["w_up"].to(cd))
    else:
        h = F.gelu(torch.bmm(xb, p["w_up"].to(cd)), approximate="tanh")
    return torch.bmm(h, p["w_down"].to(cd))


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig,
            drops: Optional[list] = None):
    """x (B, S, d) -> (out (B, S, d), lb_loss, z_loss): per-sequence
    capacity routing.  ``drops`` (optional) gets this call's count of
    dropped (token, choice) pairs appended, as a 0-d device tensor (read
    it after the forward: reading it here would wait for the device)."""
    cd = dtype_of(cfg, "compute")
    x = x.to(cd)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    w, idx, lb_loss, z_loss = _router(p, x, cfg)          # (B, S, k)

    # each (token, choice)'s position in its expert: the exclusive count
    # of that expert's earlier choices, in (token, choice) order (an int32
    # scan along the innermost axis: along the outer one, over int64, it
    # took 4.6 ms a layer at 4096 x 6 choices on the H100)
    flat = idx.reshape(b, 1, s * k)
    onehot = (flat == torch.arange(e, device=x.device)[None, :, None]).to(
        torch.int32)                                      # (B, E, S k)
    pos = (onehot.cumsum(dim=-1, dtype=torch.int32).gather(1, flat)[:, 0]
           - 1).reshape(b, s, k)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, e * cap)    # dump slot E cap
    if drops is not None:
        drops.append((~keep).sum())

    # dispatch: slot -> the token that fills it (row s, zeros, if none)
    rows = torch.arange(b, device=x.device)[:, None]
    fill = torch.full((b, e * cap + 1), s, dtype=torch.long, device=x.device)
    fill[rows, slot.reshape(b, s * k)] = torch.arange(
        s, device=x.device).repeat_interleave(k)
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    buckets = x_pad[rows, fill[:, :e * cap]].reshape(b, e, cap, d)
    # experts over model; batch over data where it divides (the prefill)
    b_ax = "data" if (b % 16 == 0) else None
    buckets = shard_hint(buckets, P(b_ax, "model", None, None))
    xb = buckets.transpose(0, 1).reshape(e, b * cap, d)
    ob = _expert_apply(p, xb, cfg).reshape(e, b, cap, d).transpose(0, 1)
    ob = shard_hint(ob, P(b_ax, "model", None, None))

    # combine: each token gathers its k slots (the dump slot reads zeros)
    ob_pad = torch.cat([ob.reshape(b, e * cap, d), ob.new_zeros(b, 1, d)],
                       dim=1)
    picked = ob_pad[rows[..., None], slot]                # (B, S, k, d)
    w_cd = (w * keep).to(cd)
    out = (picked * w_cd[..., None]).sum(dim=2)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x, cfg)
    return out, lb_loss, z_loss


def moe_ffn_decode(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, 1, d) -> (B, 1, d): every expert on every token, combined with
    the router's top-k weights."""
    cd = dtype_of(cfg, "compute")
    x2 = x[:, 0].to(cd)                                   # (B, d)
    w, idx, _, _ = _router(p, x2, cfg)                    # (B, k)
    if cfg.activation == "swiglu":
        h = F.silu(torch.matmul(x2, p["w_gate"].to(cd))) * \
            torch.matmul(x2, p["w_up"].to(cd))            # (E, B, ff)
    else:
        h = F.gelu(torch.matmul(x2, p["w_up"].to(cd)), approximate="tanh")
    all_out = torch.bmm(h, p["w_down"].to(cd))            # (E, B, d)
    gates = torch.zeros((x2.shape[0], cfg.n_experts), dtype=cd,
                        device=x.device).scatter_add_(1, idx, w.to(cd))
    out = torch.einsum("ebd,be->bd", all_out, gates)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x2, cfg)
    return out[:, None, :]
