"""Decoder-only LM for the attention architectures: GQA or MLA mixers with a
dense or MoE FFN.

Ports ``repro/models/transformer.py``: ``LayerDesc``, ``layer_desc``,
``layer_pattern``, the layer (``init_layer``, ``apply_layer``,
``decode_layer``, ``layer_cache``) and ``TransformerLM`` with ``forward``,
``loss_fn``, ``init_cache`` and ``decode_step``, plus ``softmax_xent``.

The reference scans over stacked groups of ``period`` layers (one XLA body
for any depth, ``jax.checkpoint`` on the group for training, and the FSDP
and sequence-sharding hints ``fsdp_in_scan`` and ``seq_shard_activations``
inside the scan).  Eager PyTorch has no scan, so the port holds an
``nn.ModuleList`` of all ``n_layers`` layers and loops over it; ``remat``,
``fsdp_in_scan`` and ``seq_shard_activations`` have no counterpart here.
``models.convert`` maps the reference's stacked ``groups`` leaves onto the
list.  Parameter names follow the reference's pytree:
``layers.<i>.mixer.wq`` is ``groups["pos0"]["mixer"]["wq"][i]`` for a
dense architecture, and deepseek's first (dense) layer is the reference's
``prelude[0]``.  ``forward`` sums every MoE layer's load-balance and z
losses into its aux dict, as the reference's.

Mamba and rwkv layers, M-RoPE and the encoder-decoder raise
``NotImplementedError``: later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from .layers import (apply_ffn, apply_norm, dtype_of, embed, init_embedding,
                     init_ffn, init_norm, unembed)

__all__ = ["LayerDesc", "layer_desc", "layer_pattern", "DecoderLayer",
           "TransformerLM", "softmax_xent"]


# --------------------------------------------------------------------------
# layer descriptors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str          # "attn" | "mla" | "mamba" | "rwkv"
    ffn: str            # "dense" | "moe" | "none"
    rope: bool


def layer_desc(cfg: ModelConfig, idx: int) -> LayerDesc:
    if cfg.ssm_type == "rwkv6":
        return LayerDesc("rwkv", "none", False)
    if cfg.ssm_type == "mamba" and not cfg.is_attn_layer(idx):
        mixer = "mamba"
    elif cfg.mla:
        mixer = "mla"
    else:
        mixer = "attn"
    ffn = "moe" if cfg.is_moe_layer(idx) else "dense"
    rope = not cfg.is_nope_layer(idx)
    return LayerDesc(mixer, ffn, rope)


def layer_pattern(cfg: ModelConfig) -> Tuple[int, int, List[LayerDesc]]:
    """(n_prelude, period, group descriptors), as the reference: the
    converter unstacks the reference's groups with it."""
    n_pre = cfg.first_dense_layers
    periods = [1]
    if cfg.moe and cfg.moe_layer_period > 1:
        periods.append(cfg.moe_layer_period)
    if cfg.attn_layer_period:
        periods.append(cfg.attn_layer_period)
    if cfg.nope_layer_period:
        periods.append(cfg.nope_layer_period)
    period = math.lcm(*periods)
    rem = cfg.n_layers - n_pre
    if rem % period:
        raise ValueError(f"{cfg.name}: {rem} layers not divisible by period "
                         f"{period}")
    descs = [layer_desc(cfg, n_pre + i) for i in range(period)]
    for g in range(1, rem // period):
        for i in range(period):
            if layer_desc(cfg, n_pre + g * period + i) != descs[i]:
                raise ValueError(f"{cfg.name}: non-periodic layer pattern")
    return n_pre, period, descs


def _check_ported(cfg: ModelConfig, descs: List[LayerDesc]) -> None:
    """Raise before anything is allocated for what this slice lacks."""
    if cfg.mrope_sections:
        raise attn._later("M-RoPE (qwen2-vl)")
    for desc in descs:
        if desc.mixer not in ("attn", "mla"):
            raise attn._later(f"the {desc.mixer} mixer")
        if desc.ffn not in ("dense", "moe"):
            raise attn._later(f"the {desc.ffn} FFN")


# --------------------------------------------------------------------------
# one layer
# --------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """Pre-norm layer: a GQA or MLA mixer and a dense or MoE FFN,
    sequential (``x + attn``, then ``+ ffn`` of the second norm) or, with
    ``cfg.parallel_block``, ``x + attn(h) + ffn(h)`` of one norm."""

    def __init__(self, cfg: ModelConfig, desc: LayerDesc,
                 gen: torch.Generator):
        super().__init__()
        self.cfg, self.desc = cfg, desc
        self.norm1 = init_norm(gen, cfg)
        self.mixer = (attn.init_mla(gen, cfg) if desc.mixer == "mla"
                      else attn.init_attention(gen, cfg))
        self.norm2 = init_norm(gen, cfg)
        self.ffn = (moe_mod.init_moe(gen, cfg) if desc.ffn == "moe"
                    else init_ffn(gen, cfg))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                force_kernel: bool | None = None, moe_drops=None):
        """Full-sequence layer (train / prefill), ``apply_layer``.
        Returns (x, (lb_loss, z_loss)), zeros for a dense FFN;
        ``moe_drops`` is ``moe.moe_ffn``'s ``drops``."""
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        h = apply_norm(self.norm1, x, cfg)
        if self.desc.mixer == "mla":
            y = attn.mla_forward(self.mixer, h, cfg, positions,
                                 force_kernel=force_kernel)
        else:
            y = attn.attn_forward(self.mixer, h, cfg, positions,
                                  use_rope=self.desc.rope,
                                  force_kernel=force_kernel)
        if cfg.parallel_block:
            return x + y + apply_ffn(self.ffn, h, cfg), (zero, zero)
        x = x + y
        h2 = apply_norm(self.norm2, x, cfg)
        if self.desc.ffn == "moe":
            f, lb, z = moe_mod.moe_ffn(self.ffn, h2, cfg, drops=moe_drops)
            return x + f, (lb, z)
        return x + apply_ffn(self.ffn, h2, cfg), (zero, zero)

    def decode(self, x: torch.Tensor, cache: dict, pos, *, proj=None):
        """One-token layer step, ``decode_layer``.  ``pos`` is a scalar or
        (B,) per-slot positions; ``proj`` optionally reroutes this layer's
        projections through coded sites: ``{"qkv", "o"}`` feed the GQA or
        MLA mixer, ``{"up", "down"}`` the dense FFN (a MoE FFN stays
        uncoded, as in the reference).  Returns (x, cache)."""
        cfg = self.cfg
        proj = proj or {}
        h = apply_norm(self.norm1, x, cfg)
        mix = {k: proj.get(k) for k in ("qkv", "o")}
        if self.desc.mixer == "mla":
            y, cache = attn.mla_decode(self.mixer, h, cache, pos, cfg,
                                       proj=mix)
        else:
            y, cache = attn.attn_decode(self.mixer, h, cache, pos, cfg,
                                        use_rope=self.desc.rope, proj=mix)
        ffn_mm = {"matmul_up": proj.get("up"),
                  "matmul_down": proj.get("down")}
        if cfg.parallel_block:
            return x + y + apply_ffn(self.ffn, h, cfg, **ffn_mm), cache
        x = x + y
        h2 = apply_norm(self.norm2, x, cfg)
        if self.desc.ffn == "moe":
            return x + moe_mod.moe_ffn_decode(self.ffn, h2, cfg), cache
        return x + apply_ffn(self.ffn, h2, cfg, **ffn_mm), cache

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """This layer's decode cache (``layer_cache``): ``{k, v}`` for GQA,
        ``{ckv, kpe}`` for MLA, zeros in the compute dtype."""
        if self.desc.mixer == "mla":
            return attn.init_mla_cache(self.cfg, batch, max_len,
                                       device=device)
        return attn.init_kv_cache(self.cfg, batch, max_len, device=device)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """Decoder-only LM: forward (train / prefill), loss and decode.

    Built by ``models.build_model`` on one device from a seeded
    ``torch.Generator``.  On CUDA tensors every attention layer (GQA or
    MLA) of ``forward`` launches the flash kernel once; run it under
    ``torch.inference_mode()`` (the kernel has no backward yet).
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        if cfg.encoder_decoder:
            raise attn._later("the encoder-decoder LM (whisper)")
        _check_ported(cfg, [layer_desc(cfg, i) for i in range(cfg.n_layers)])
        self.cfg = cfg
        self.n_pre, self.period, self.descs = layer_pattern(cfg)
        self.n_groups = (cfg.n_layers - self.n_pre) // self.period
        self.embedding = init_embedding(gen, cfg)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, layer_desc(cfg, i), gen)
            for i in range(cfg.n_layers))
        self.final_norm = init_norm(gen, cfg)

    # ---- forward (train / prefill) ------------------------------------
    def forward(self, tokens: torch.Tensor, *, mrope_positions=None,
                force_kernel: bool | None = None, moe_drops=None):
        """tokens (B, S) -> (logits (B, S, V), aux dict with the summed
        ``lb_loss`` and ``z_loss`` of the MoE layers).  ``force_kernel``
        reaches every layer's ``kernels.ops.flash_attention``;
        ``moe_drops`` (optional list) gets each MoE layer's count of
        capacity-dropped (token, choice) pairs, in layer order."""
        if mrope_positions is not None:
            raise attn._later("M-RoPE (mrope_positions=)")
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        x = embed(self.embedding, tokens, cfg)
        lb_tot = z_tot = torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)
        for layer in self.layers:
            x, (lb, z) = layer(x, positions, force_kernel=force_kernel,
                               moe_drops=moe_drops)
            lb_tot, z_tot = lb_tot + lb, z_tot + z
        x = apply_norm(self.final_norm, x, cfg)
        logits = unembed(self.embedding, x, cfg)
        return logits, {"lb_loss": lb_tot, "z_loss": z_tot}

    def loss_fn(self, batch: dict):
        """batch: tokens (B, S), targets (B, S) -> (loss, metrics)."""
        logits, aux = self.forward(batch["tokens"],
                                   mrope_positions=batch.get(
                                       "mrope_positions"))
        ce = softmax_xent(logits, batch["targets"])
        loss = ce + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        return loss, {"ce": ce, **aux}

    # ---- decode --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[dict]:
        """One cache dict per layer (``DecoderLayer.init_cache``), zeros
        in the compute dtype."""
        dev = self.embedding["table"].device
        return [layer.init_cache(batch, max_len, dev)
                for layer in self.layers]

    def decode_step(self, cache: List[dict], tokens: torch.Tensor, pos, *,
                    return_hidden: bool = False):
        """tokens (B, 1), ``pos`` a scalar or (B,) per-slot positions ->
        (logits (B, 1, V), cache); the cache is written in place.
        ``return_hidden`` yields the final-norm hidden state (B, 1, d)
        instead of logits (the serve loop's round mode runs the unembed as
        a coded round)."""
        cfg = self.cfg
        x = embed(self.embedding, tokens, cfg)
        for i, layer in enumerate(self.layers):
            x, cache[i] = layer.decode(x, cache[i], pos)
        x = apply_norm(self.final_norm, x, cfg)
        if return_hidden:
            return x, cache
        return unembed(self.embedding, x, cfg), cache


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over targets >= 0 (targets == -1 are masked out)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = targets.clamp(min=0).long()
    picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    mask = (targets >= 0).to(torch.float32)
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)
