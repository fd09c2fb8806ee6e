"""Decoder-only LM: GQA, MLA, Mamba or RWKV6 mixers with a dense, MoE or
(RWKV6's channel mix) no FFN.

Ports ``repro/models/transformer.py``: ``LayerDesc``, ``layer_desc``,
``layer_pattern``, the layer (``init_layer``, ``apply_layer``,
``decode_layer``, ``layer_cache``) and ``TransformerLM`` with ``forward``,
``loss_fn``, ``init_cache`` and ``decode_step``, plus ``softmax_xent``.

The reference scans over stacked groups of ``period`` layers (one XLA body
for any depth, ``jax.checkpoint`` on the group for training, and the FSDP
and sequence-sharding hints ``fsdp_in_scan`` and ``seq_shard_activations``
inside the scan).  Eager PyTorch has no scan, so the port holds an
``nn.ModuleList`` of all ``n_layers`` layers and loops over it;
``fsdp_in_scan`` has no counterpart here; ``seq_shard_activations``
pins the residual stream between layers sequence-sharded over ``model``
(``shard_hint``), as the reference's scan body.
``cfg.remat`` recomputes each layer (not each group of ``period``) in the
backward: ``forward`` calls every ``DecoderLayer`` through
``layers.remat`` when grad is enabled, so a full-depth step keeps one
residual stream per layer and one layer's activations at a time.  The
MoE layers' dropped-choice counts (``moe_drops``) are recorded once per
forward, not again by the recomputation; the flash kernel's launch
counter counts both forwards of a layer (two launches per attention layer
and backward, plus one backward kernel call).
``models.convert`` maps the reference's stacked ``groups`` leaves onto the
list.  Parameter names follow the reference's pytree:
``layers.<i>.mixer.wq`` is ``groups["pos0"]["mixer"]["wq"][i]`` for a
dense architecture, and deepseek's first (dense) layer is the reference's
``prelude[0]``.  ``forward`` sums every MoE layer's load-balance and z
losses into its aux dict, as the reference's.

The SSM mixers (``models.ssm``) follow the reference's layer: an rwkv
layer is norm1 -> time mix -> norm2 -> channel mix with no ``ffn`` leaf;
a mamba layer (jamba's) takes a dense or MoE FFN like an attention layer.
``forward`` hands each SSM layer a zero float32 state and drops the new
one (``layer_init_state``); ``decode`` writes the new state into the
cache's tensors in place, as the KV cache is written, so that a step on
views of a larger cache (the serve loop's bucket) lands in it.

Qwen2-VL's M-RoPE rides on the GQA layer: ``forward``, ``loss_fn`` (the
batch's ``mrope_positions``) and ``decode_step`` hand (3, B, S) position
streams down to ``attention.attn_forward``/``attn_decode``; without them
the layer takes plain RoPE, as the reference's does (and as its serve
loop's decode does).  The encoder-decoder (whisper) is
``models.encdec.EncDecLM``.

On a device mesh (``dist.sharding.distribute_params`` places the
parameters by ``param_specs``, keyed by parameter name; the reference's
stacked ``groups`` axis, unsharded there, has no counterpart) the same
code runs on DTensors under ``launch.mesh.use_mesh``: tensor parallel
over heads, FFN width and vocabulary.  The residual stream is pinned
replicated over ``model`` (batch over ``data``) at each norm's output and
each residual sum (``_pin``): in the forward a partial sum is all-reduced
there, and in the backward a partial gradient is (Megatron's f and g), so
every weight gradient keeps its weight's placement.  On one device the
pins are the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..dist.sharding import P, gathered, shard_hint
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import (apply_ffn, apply_norm, dtype_of, embed, embedding_specs,
                     ffn_specs, init_embedding, init_ffn, init_norm,
                     norm_specs, remat, unembed)

__all__ = ["LayerDesc", "layer_desc", "layer_pattern", "layer_specs",
           "layer_cache_specs", "DecoderLayer", "TransformerLM",
           "softmax_xent"]

# the residual stream on a mesh: batch over data, replicated over model
_RESIDUAL = P("data", None, None)


def _pin(x):
    return shard_hint(x, _RESIDUAL)


def _prefixed(prefix: str, tree: dict, out: dict) -> dict:
    """A nested spec dict flattened to {prefix + dotted path: P}."""
    for key, value in tree.items():
        if isinstance(value, P):
            out[f"{prefix}{key}"] = value
        else:
            _prefixed(f"{prefix}{key}.", value, out)
    return out


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


def layer_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    p = {"norm1": norm_specs(cfg)}
    if desc.mixer == "attn":
        p["mixer"] = attn.attention_specs(cfg)
    elif desc.mixer == "mla":
        p["mixer"] = attn.mla_specs(cfg)
    elif desc.mixer == "mamba":
        p["mixer"] = ssm.mamba_block_specs(cfg)
    else:
        p["mixer"] = ssm.rwkv_block_specs(cfg)
    if desc.ffn != "none" or desc.mixer == "rwkv":
        p["norm2"] = norm_specs(cfg)
    if desc.ffn == "dense":
        p["ffn"] = ffn_specs(cfg)
    elif desc.ffn == "moe":
        p["ffn"] = moe_mod.moe_specs(cfg)
    return p


def layer_cache_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    if desc.mixer == "rwkv":
        return ssm.rwkv_state_specs(cfg)
    if desc.mixer == "mamba":
        return ssm.mamba_state_specs(cfg)
    if desc.mixer == "mla":
        return attn.mla_cache_specs(cfg)
    return attn.kv_cache_specs(cfg)


def layer_init_state(cfg: ModelConfig, desc: LayerDesc, batch: int,
                     device) -> dict | None:
    """An SSM layer's zero float32 recurrent state (None for attention):
    the forward's initial state, and the layer's decode cache."""
    if desc.mixer == "rwkv":
        return ssm.init_rwkv_state(cfg, batch, device=device)
    if desc.mixer == "mamba":
        return ssm.init_mamba_state(cfg, batch, device=device)
    return None


def _write_state(cache: dict, new: dict) -> dict:
    """Copy a new recurrent state into the cache's tensors (which may be
    views of a larger cache); returns the cache."""
    for key, value in new.items():
        if value is not cache[key]:
            cache[key].copy_(value)
    return cache


# --------------------------------------------------------------------------
# one layer
# --------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """Pre-norm layer: a GQA, MLA or Mamba mixer and a dense or MoE FFN,
    sequential (``x + mixer``, then ``+ ffn`` of the second norm) or, with
    ``cfg.parallel_block``, ``x + mixer(h) + ffn(h)`` of one norm; or an
    RWKV6 block (time mix, then channel mix of the second norm, no
    ``ffn``)."""

    def __init__(self, cfg: ModelConfig, desc: LayerDesc,
                 gen: torch.Generator):
        super().__init__()
        self.cfg, self.desc = cfg, desc
        self.norm1 = init_norm(gen, cfg)
        init_mixer = {"attn": attn.init_attention, "mla": attn.init_mla,
                      "mamba": ssm.init_mamba_block,
                      "rwkv": ssm.init_rwkv_block}[desc.mixer]
        self.mixer = init_mixer(gen, cfg)
        self.norm2 = init_norm(gen, cfg)
        self.ffn = (moe_mod.init_moe(gen, cfg) if desc.ffn == "moe"
                    else init_ffn(gen, cfg) if desc.ffn == "dense" else None)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                mrope_positions=None, force_kernel: bool | None = None,
                moe_drops=None):
        """Full-sequence layer (train / prefill), ``apply_layer``.
        Returns (x, (lb_loss, z_loss)), zeros for a dense FFN;
        ``mrope_positions`` (3, B, S) reach a GQA mixer's M-RoPE;
        ``moe_drops`` is ``moe.moe_ffn``'s ``drops``."""
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        h = _pin(apply_norm(self.norm1, x, cfg))
        state = layer_init_state(cfg, self.desc, x.shape[0], x.device)
        if self.desc.mixer == "rwkv":
            y, state = ssm.rwkv_time_mix(self.mixer, h, state, cfg)
            x = _pin(x + y)
            h2 = _pin(apply_norm(self.norm2, x, cfg))
            y2, _ = ssm.rwkv_channel_mix(self.mixer, h2, state, cfg)
            return _pin(x + y2), (zero, zero)
        if self.desc.mixer == "mamba":
            y, _ = ssm.mamba_forward(self.mixer, h, state, cfg)
        elif self.desc.mixer == "mla":
            y = attn.mla_forward(self.mixer, h, cfg, positions,
                                 force_kernel=force_kernel)
        else:
            y = attn.attn_forward(self.mixer, h, cfg, positions,
                                  use_rope=self.desc.rope,
                                  mrope_positions=mrope_positions,
                                  force_kernel=force_kernel)
        if cfg.parallel_block:
            return _pin(x + y + apply_ffn(self.ffn, h, cfg)), (zero, zero)
        x = _pin(x + y)
        h2 = _pin(apply_norm(self.norm2, x, cfg))
        if self.desc.ffn == "moe":
            f, lb, z = moe_mod.moe_ffn(self.ffn, h2, cfg, drops=moe_drops)
            return _pin(x + f), (lb, z)
        return _pin(x + apply_ffn(self.ffn, h2, cfg)), (zero, zero)

    def decode(self, x: torch.Tensor, cache: dict, pos, *,
               mrope_positions=None, proj=None):
        """One-token layer step, ``decode_layer``.  ``pos`` is a scalar or
        (B,) per-slot positions; ``mrope_positions`` (3, B, 1) reach a GQA
        mixer's M-RoPE; ``proj`` optionally reroutes this layer's
        projections through coded sites: ``{"qkv", "o"}`` feed the GQA or
        MLA mixer, ``{"up", "down"}`` the dense FFN (a MoE FFN and the SSM
        mixers stay uncoded, as in the reference).  Returns (x, cache),
        the cache written in place.  An rwkv layer runs the time mix's
        and the channel mix's decode steps; a mamba layer its decode
        step; each writes its new state into the cache."""
        cfg = self.cfg
        proj = proj or {}
        h = _pin(apply_norm(self.norm1, x, cfg))
        mix = {k: proj.get(k) for k in ("qkv", "o")}
        if self.desc.mixer == "rwkv":
            y, new = ssm.rwkv_decode_step(self.mixer, h, cache, cfg)
            x = _pin(x + y)
            h2 = _pin(apply_norm(self.norm2, x, cfg))
            y2, new = ssm.rwkv_channel_mix_decode(self.mixer, h2, new, cfg)
            return _pin(x + y2), _write_state(cache, new)
        if self.desc.mixer == "mamba":
            y, new = ssm.mamba_decode_step(self.mixer, h, cache, cfg)
            cache = _write_state(cache, new)
        elif self.desc.mixer == "mla":
            y, cache = attn.mla_decode(self.mixer, h, cache, pos, cfg,
                                       proj=mix)
        else:
            y, cache = attn.attn_decode(self.mixer, h, cache, pos, cfg,
                                        use_rope=self.desc.rope,
                                        mrope_positions=mrope_positions,
                                        proj=mix)
        ffn_mm = {"matmul_up": proj.get("up"),
                  "matmul_down": proj.get("down")}
        if cfg.parallel_block:
            return _pin(x + y + apply_ffn(self.ffn, h, cfg, **ffn_mm)), cache
        x = _pin(x + y)
        h2 = _pin(apply_norm(self.norm2, x, cfg))
        if self.desc.ffn == "moe":
            return _pin(x + moe_mod.moe_ffn_decode(self.ffn, h2, cfg)), cache
        return _pin(x + apply_ffn(self.ffn, h2, cfg, **ffn_mm)), cache

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """This layer's decode cache (``layer_cache``): ``{k, v}`` for GQA
        and ``{ckv, kpe}`` for MLA, zeros in the compute dtype; the
        recurrent state for an SSM mixer, float32 zeros (``{tm_x, cm_x,
        wkv}`` for rwkv, ``{conv, ssm}`` for mamba), as the reference's."""
        state = layer_init_state(self.cfg, self.desc, batch, device)
        if state is not None:
            return state
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
    MLA) of ``forward`` launches the flash kernel once (an SSM layer
    none), and trains through it: a backward runs the flash backward
    kernel once per attention layer and, with ``cfg.remat``, the forward
    kernel once more.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
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
        ``lb_loss`` and ``z_loss`` of the MoE layers).  ``mrope_positions``
        (3, B, S) are the M-RoPE streams of a config with sections (None:
        plain RoPE).  ``force_kernel`` reaches every layer's
        ``kernels.ops.flash_attention``; ``moe_drops`` (optional list) gets
        each MoE layer's count of capacity-dropped (token, choice) pairs,
        in layer order."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        x = _pin(embed(self.embedding, tokens, cfg))
        lb_tot = z_tot = torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)
        for layer in self.layers:
            x, (lb, z) = _layer_call(layer, x, positions, mrope_positions,
                                     force_kernel, moe_drops)
            if cfg.seq_shard_activations:
                # sequence parallelism: the layer-boundary residual (the
                # remat-saved input) lives sequence-sharded over model
                x = shard_hint(x, P(None, "model", None))
            lb_tot, z_tot = lb_tot + lb, z_tot + z
        x = _pin(apply_norm(self.final_norm, x, cfg))
        logits = unembed(self.embedding, x, cfg)
        return logits, {"lb_loss": lb_tot, "z_loss": z_tot}

    def loss_fn(self, batch: dict):
        """batch: tokens (B, S), targets (B, S), optionally
        mrope_positions (3, B, S) -> (loss, metrics)."""
        logits, aux = self.forward(batch["tokens"],
                                   mrope_positions=batch.get(
                                       "mrope_positions"))
        ce = softmax_xent(logits, batch["targets"])
        loss = ce + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        return loss, {"ce": ce, **aux}

    # ---- decode --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[dict]:
        """One cache dict per layer (``DecoderLayer.init_cache``): zeros,
        in the compute dtype for attention and in float32 for an SSM
        layer's state."""
        dev = self.embedding["table"].device
        return [layer.init_cache(batch, max_len, dev)
                for layer in self.layers]

    def decode_step(self, cache: List[dict], tokens: torch.Tensor, pos, *,
                    mrope_positions=None, return_hidden: bool = False):
        """tokens (B, 1), ``pos`` a scalar or (B,) per-slot positions ->
        (logits (B, 1, V), cache); the cache is written in place.
        ``mrope_positions`` (3, B, 1) are the M-RoPE streams of this token
        (None: plain RoPE at ``pos``, as the serve loop decodes).
        ``return_hidden`` yields the final-norm hidden state (B, 1, d)
        instead of logits (the serve loop's round mode runs the unembed as
        a coded round)."""
        cfg = self.cfg
        x = _pin(embed(self.embedding, tokens, cfg))
        for i, layer in enumerate(self.layers):
            x, cache[i] = layer.decode(x, cache[i], pos,
                                       mrope_positions=mrope_positions)
        x = _pin(apply_norm(self.final_norm, x, cfg))
        if return_hidden:
            return x, cache
        return unembed(self.embedding, x, cfg), cache

    # ---- sharding specs --------------------------------------------------
    def param_specs(self) -> dict:
        """{parameter name: PartitionSpec}, the reference's
        ``param_specs`` by the port's names (no stacked ``groups`` axis)."""
        cfg = self.cfg
        out = _prefixed("embedding.", embedding_specs(cfg), {})
        for i, layer in enumerate(self.layers):
            _prefixed(f"layers.{i}.", layer_specs(cfg, layer.desc), out)
        return _prefixed("final_norm.", norm_specs(cfg), out)

    def cache_specs(self) -> List[dict]:
        """One spec dict per layer, congruent with ``init_cache``."""
        return [layer_cache_specs(self.cfg, layer.desc)
                for layer in self.layers]


def _layer_call(layer: DecoderLayer, x, positions, mrope_positions,
                force_kernel, moe_drops):
    """One layer of ``forward`` through ``layers.remat``: the MoE drop
    counts of its first run reach ``moe_drops``, the recomputation's do
    not."""
    recorded = []

    def run(x):
        drops = None if moe_drops is None else []
        out = layer(x, positions, mrope_positions=mrope_positions,
                    force_kernel=force_kernel, moe_drops=drops)
        if drops is not None and not recorded:
            moe_drops.extend(drops)
            recorded.append(True)
        return out
    return remat(layer.cfg, run, x)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over targets >= 0 (targets == -1 are masked out).  On a
    mesh the vocab-sharded logits are gathered over ``model`` first (the
    reference's partitioner inserts the reductions; DTensor's gather
    cannot index a sharded dim); their gradient stays vocab-sharded."""
    logits = gathered(logits, P("data", None, None))
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = targets.clamp(min=0).long()
    picked = torch.gather(lf, -1, tgt[..., None])[..., 0]
    mask = (targets >= 0).to(torch.float32)
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)
