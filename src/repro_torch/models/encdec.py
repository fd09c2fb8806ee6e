"""Encoder-decoder LM (whisper-small): forward, loss and decode.

Ports ``repro/models/encdec.py``'s ``EncDecLM`` (``encode``, ``forward``,
``loss_fn``, ``init_cache``, ``decode_step``, ``param_specs``,
``cache_specs``) and ``CROSS_LEN``.

Encoder: precomputed frame embeddings (B, S_enc, d) (the conv frontend is
a stub, as in the reference) plus sinusoidal positions, then bidirectional
self-attention layers (norm1, attn, norm2, ffn) and ``enc_norm``.  Decoder:
token embeddings plus sinusoidal positions, then layers of causal
self-attention, cross-attention to the encoder output (k and v from
``attention.project_kv`` of it, per layer) and the FFN (norm1, self_attn,
norm2, cross_attn, norm3, ffn), ``final_norm`` and the unembed.  No layer
takes RoPE (whisper's ``rope_theta`` is 0).  On CUDA tensors one
``forward`` launches the flash kernel once per encoder layer (full), and
twice per decoder layer (causal self, full cross).

The reference stacks each side's layers on a leading axis and scans; the
port holds them in ``nn.ModuleList``s ``encoder`` and ``decoder``, and
``models.convert`` unstacks the reference's leaves onto them.  As the
reference checkpoints its scanned bodies (``jax.checkpoint`` under
``cfg.remat``), each encoder and decoder layer runs through
``layers.remat`` when grad is enabled.

Decode: each layer's cache is ``{"self": {k, v}, "cross": {k, v}}``, the
cross rows (``CROSS_LEN`` of them) filled by the caller with ``project_kv``
of the encoder output, every row attended.  ``pos`` is a scalar, as in the
reference, whose one-position sinusoid does not broadcast over per-slot
positions: a (B,) ``pos`` raises ``ValueError``.  The reference's serve
loop has no encoder-decoder path, so neither has the port's.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn
from ..dist.sharding import P
from .layers import (apply_ffn, apply_norm, dtype_of, embed, embedding_specs,
                     ffn_specs, init_embedding, init_ffn, init_norm,
                     norm_specs, remat, sinusoidal_positions, unembed)
from .transformer import _prefixed, softmax_xent

__all__ = ["EncDecLM", "CROSS_LEN"]

CROSS_LEN = 4096  # encoder context carried into decode (the reference's)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = init_norm(gen, cfg)
        self.attn = attn.init_attention(gen, cfg)
        self.norm2 = init_norm(gen, cfg)
        self.ffn = init_ffn(gen, cfg)

    def forward(self, x, pos, cfg: ModelConfig, force_kernel=None):
        h = apply_norm(self.norm1, x, cfg)
        x = x + attn.attn_forward(self.attn, h, cfg, pos, causal=False,
                                  use_rope=False, force_kernel=force_kernel)
        h2 = apply_norm(self.norm2, x, cfg)
        return x + apply_ffn(self.ffn, h2, cfg)


class CrossDecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = init_norm(gen, cfg)
        self.self_attn = attn.init_attention(gen, cfg)
        self.norm2 = init_norm(gen, cfg)
        self.cross_attn = attn.init_attention(gen, cfg)
        self.norm3 = init_norm(gen, cfg)
        self.ffn = init_ffn(gen, cfg)

    def forward(self, x, enc, enc_pos, dec_pos, cfg: ModelConfig,
                force_kernel=None):
        h = apply_norm(self.norm1, x, cfg)
        x = x + attn.attn_forward(self.self_attn, h, cfg, dec_pos,
                                  causal=True, use_rope=False,
                                  force_kernel=force_kernel)
        h2 = apply_norm(self.norm2, x, cfg)
        ck, cv = attn.project_kv(self.cross_attn, enc, cfg, enc_pos)
        x = x + attn.attn_forward(self.cross_attn, h2, cfg, dec_pos,
                                  causal=False, use_rope=False,
                                  kv=(ck, cv, enc_pos),
                                  force_kernel=force_kernel)
        h3 = apply_norm(self.norm3, x, cfg)
        return x + apply_ffn(self.ffn, h3, cfg)


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {"norm1": norm_specs(cfg), "attn": attn.attention_specs(cfg),
            "norm2": norm_specs(cfg), "ffn": ffn_specs(cfg)}


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {"norm1": norm_specs(cfg), "self_attn": attn.attention_specs(cfg),
            "norm2": norm_specs(cfg), "cross_attn": attn.attention_specs(cfg),
            "norm3": norm_specs(cfg), "ffn": ffn_specs(cfg)}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder, built by ``models.build_model`` on one
    device from a seeded ``torch.Generator``.  ``forward`` trains through
    the flash kernels on the card (``kernels.ops.flash_attention``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embedding = init_embedding(gen, cfg)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, gen)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(CrossDecoderLayer(cfg, gen)
                                     for _ in range(cfg.n_layers))
        self.enc_norm = init_norm(gen, cfg)
        self.final_norm = init_norm(gen, cfg)

    def param_specs(self) -> dict:
        """{parameter name: PartitionSpec}, the reference's by the port's
        names (its stacked layer axis, unsharded, has no counterpart)."""
        cfg = self.cfg
        out = _prefixed("embedding.", embedding_specs(cfg), {})
        for g in range(len(self.encoder)):
            _prefixed(f"encoder.{g}.", _enc_layer_specs(cfg), out)
        for g in range(len(self.decoder)):
            _prefixed(f"decoder.{g}.", _dec_layer_specs(cfg), out)
        _prefixed("enc_norm.", norm_specs(cfg), out)
        return _prefixed("final_norm.", norm_specs(cfg), out)

    # ---- encoder ------------------------------------------------------
    def encode(self, frames: torch.Tensor, *,
               force_kernel: bool | None = None) -> torch.Tensor:
        """frames (B, S_enc, d), precomputed frontend embeddings -> the
        encoder output (B, S_enc, d) in the compute dtype."""
        cfg = self.cfg
        cd = dtype_of(cfg, "compute")
        b, s, _ = frames.shape
        pos = _positions(b, s, frames.device)
        x = frames.to(cd) + sinusoidal_positions(s, cfg.d_model, cd,
                                                 frames.device)[None]
        for layer in self.encoder:
            x = remat(cfg, layer, x, pos, cfg, force_kernel)
        return apply_norm(self.enc_norm, x, cfg)

    # ---- decoder (teacher-forced) ---------------------------------------
    def forward(self, frames: torch.Tensor, tokens: torch.Tensor, *,
                force_kernel: bool | None = None):
        """frames (B, S_enc, d), tokens (B, S_dec) -> (logits (B, S_dec,
        V), {}).  ``force_kernel`` reaches every
        ``kernels.ops.flash_attention`` call."""
        cfg = self.cfg
        cd = dtype_of(cfg, "compute")
        enc = self.encode(frames, force_kernel=force_kernel)
        b, sd = tokens.shape
        enc_pos = _positions(b, enc.shape[1], tokens.device)
        dec_pos = _positions(b, sd, tokens.device)
        x = embed(self.embedding, tokens, cfg) + sinusoidal_positions(
            sd, cfg.d_model, cd, tokens.device)[None]
        for layer in self.decoder:
            x = remat(cfg, layer, x, enc, enc_pos, dec_pos, cfg,
                      force_kernel)
        x = apply_norm(self.final_norm, x, cfg)
        return unembed(self.embedding, x, cfg), {}

    def loss_fn(self, batch: dict):
        """batch: frames (B, S_enc, d), tokens and targets (B, S_dec) ->
        (mean CE over targets >= 0, {"ce": it})."""
        logits, _ = self.forward(batch["frames"], batch["tokens"])
        ce = softmax_xent(logits, batch["targets"])
        return ce, {"ce": ce}

    # ---- decode ---------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[dict]:
        """One ``{"self": {k, v}, "cross": {k, v}}`` per decoder layer:
        zeros in the compute dtype, the self cache ``max_len`` rows long
        and the cross cache ``CROSS_LEN``."""
        cfg = self.cfg
        dev = self.embedding["table"].device
        shape = (batch, CROSS_LEN, cfg.n_kv_heads_padded, cfg.head_dim_)
        cd = dtype_of(cfg, "compute")
        return [{"self": attn.init_kv_cache(cfg, batch, max_len, device=dev),
                 "cross": {"k": torch.zeros(shape, dtype=cd, device=dev),
                           "v": torch.zeros(shape, dtype=cd, device=dev)}}
                for _ in self.decoder]

    def cache_specs(self) -> List[dict]:
        """One spec dict per decoder layer, congruent with
        ``init_cache``."""
        one = {"self": attn.kv_cache_specs(self.cfg),
               "cross": {"k": P("data", "model", None, None),
                         "v": P("data", "model", None, None)}}
        return [one for _ in self.decoder]

    def decode_step(self, cache: List[dict], tokens: torch.Tensor, pos, *,
                    return_hidden: bool = False):
        """tokens (B, 1) at the scalar position ``pos`` -> (logits (B, 1,
        V), cache), each layer's self cache written in place at ``pos``;
        ``return_hidden`` yields the final-norm hidden state (B, 1, d)
        instead of logits."""
        if (torch.is_tensor(pos) and pos.dim() > 0) or \
                getattr(pos, "ndim", 0) > 0:
            raise ValueError("EncDecLM.decode_step takes a scalar pos (the "
                             "reference's sinusoid does not broadcast over "
                             f"per-slot positions), got shape "
                             f"{tuple(pos.shape)}")
        cfg = self.cfg
        cd = dtype_of(cfg, "compute")
        x = embed(self.embedding, tokens, cfg)
        dim = torch.arange(cfg.d_model // 2, dtype=torch.float32,
                           device=x.device)
        ang = float(pos) / 10000.0 ** (2.0 * dim / cfg.d_model)
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(cd)
        for layer, lc in zip(self.decoder, cache):
            h = apply_norm(layer.norm1, x, cfg)
            y, lc["self"] = attn.attn_decode(layer.self_attn, h, lc["self"],
                                             pos, cfg, use_rope=False)
            x = x + y
            h2 = apply_norm(layer.norm2, x, cfg)
            y2, _ = attn.attn_decode(layer.cross_attn, h2, None, pos, cfg,
                                     use_rope=False, cross_kv=lc["cross"])
            x = x + y2
            h3 = apply_norm(layer.norm3, x, cfg)
            x = x + apply_ffn(layer.ffn, h3, cfg)
        x = apply_norm(self.final_norm, x, cfg)
        if return_hidden:
            return x, cache
        return unembed(self.embedding, x, cfg), cache
