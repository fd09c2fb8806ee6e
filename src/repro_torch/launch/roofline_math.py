"""Analytic MODEL_FLOPS per (arch × shape): the 'useful work' yardstick.

Ports ``repro/launch/roofline_math.py`` (``model_flops``, ``_attn_dims``,
``_n_attn_layers``): integer arithmetic over the port's own
``configs.base``, equal to the reference's for every arch and shape.

Conventions:
  * train  : 6·N_nonemb_active per token (fwd 2N + bwd 4N) + 6·d·V unembed
             + causal self-attention 6·S·H_pad·hd per attention layer/token.
  * prefill: 2·N_nonemb_active + causal attention 2·S·H_pad·hd /attn layer
             (next-token logits only → unembed counted once per sequence).
  * decode : 2·N_nonemb_active + 2·d·V + KV-cache attention 4·S_ctx·H_pad·hd
             per attention layer (MLA: latent-space dims instead).
  * MoE    : active experts only (top-k + shared) — capacity-factor slack,
             padded heads, remat recompute and all-expert decode all show up
             as MODEL_FLOPS / HLO_FLOPS < 1, which is the point of the ratio.
  * whisper: encoder tokens and decoder tokens costed separately.
"""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeSpec


def _attn_dims(cfg: ModelConfig):
    if cfg.mla:
        # decode runs in absorbed latent space
        return cfg.n_heads_padded, (cfg.kv_lora_rank + cfg.qk_rope_head_dim) // 2
    return cfg.n_heads_padded, cfg.head_dim_


def _n_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers)
               if cfg.ssm_type == "" or cfg.is_attn_layer(i))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    n_active = cfg.param_count(active_only=True)
    emb_params = v * d * (1 if cfg.tie_embeddings else 2)
    n_nonemb = max(n_active - emb_params, 0)
    hp, hd = _attn_dims(cfg)
    n_attn = _n_attn_layers(cfg)
    b, s = shape.global_batch, shape.seq_len

    if cfg.encoder_decoder and shape.kind in ("train", "prefill"):
        sd = max(s // cfg.dec_len_ratio, 16)
        # split params between encoder/decoder stacks (same width)
        per_enc = cfg.d_model * cfg.n_heads_padded * cfg.head_dim_ * 4 + \
            2 * cfg.d_model * cfg.d_ff
        per_dec = cfg.d_model * cfg.n_heads_padded * cfg.head_dim_ * 8 + \
            2 * cfg.d_model * cfg.d_ff
        mult = 6 if shape.kind == "train" else 2
        enc_tok, dec_tok = b * s, b * sd
        f = mult * (per_enc * cfg.n_encoder_layers * enc_tok +
                    per_dec * cfg.n_layers * dec_tok)
        # attention: encoder full S², decoder causal + cross S·Sd
        att = mult * hp * hd * (cfg.n_encoder_layers * enc_tok * s +
                                cfg.n_layers * dec_tok * (sd // 2 + s))
        f += att + (mult * d * v * dec_tok if shape.kind == "train"
                    else 2 * d * v * b)
        tokens = dec_tok
    elif shape.kind == "train":
        tokens = b * s
        # causal attention: token t attends to t keys -> S(S+1)/2 per head pair
        f = tokens * (6 * n_nonemb + 6 * d * v) + \
            6 * hp * hd * n_attn * b * (s * (s + 1) // 2)
    elif shape.kind == "prefill":
        tokens = b * s
        f = tokens * 2 * n_nonemb + 2 * d * v * b + \
            2 * hp * hd * n_attn * b * (s * (s + 1) // 2) * 2
    else:  # decode: one token, S_ctx cache
        tokens = b
        f = tokens * (2 * n_nonemb + 2 * d * v + 4 * s * hp * hd * n_attn)

    return {"model_flops_global": float(f), "tokens": int(tokens),
            "n_active_params": int(n_active), "n_nonemb_active": int(n_nonemb)}
