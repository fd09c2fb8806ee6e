"""Architecture registry: --arch <id> -> ModelConfig.

A copy of ``repro/configs/__init__.py`` (``ARCHS``, ``get_config``,
``tiny_config``) over the port's own copies of the config files.
"""

from .base import SHAPES, ModelConfig, ShapeSpec

from . import (command_r_35b, deepseek_v2_lite, jamba_v01_52b, llama4_scout,
               phi3_mini, qwen2_7b, qwen2_vl_72b, qwen3_14b, rwkv6_1b6,
               whisper_small)

ARCHS = {
    "whisper-small": whisper_small.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout.CONFIG,
    "phi3-mini-3.8b": phi3_mini.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
}

# archs with sub-quadratic sequence mixing run the long_500k cell
LONG_CONTEXT_ARCHS = {"rwkv6-1.6b", "jamba-v0.1-52b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}")
    return ARCHS[name]


def shape_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skip) for an (arch, shape) cell."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "full-attention arch: 500k KV decode excluded per assignment (sub-quadratic only)"
    return True, ""


def tiny_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths/layers,
    few experts, tiny vocab — structure preserved."""
    import dataclasses
    cfg = get_config(name)
    reduced = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else 0,
        pad_heads_to=1,
    )
    if cfg.encoder_decoder:
        reduced["n_encoder_layers"] = 2
        reduced["n_layers"] = 2
    if cfg.mla:
        reduced.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                       v_head_dim=16, head_dim=24)
    if cfg.moe:
        reduced.update(n_experts=8 if cfg.n_experts >= 64 else 4,
                       top_k=min(cfg.top_k, 2), moe_d_ff=128)
    if cfg.ssm_type == "rwkv6":
        reduced.update(rwkv_head_dim=16, n_heads=4, n_kv_heads=4)
    if cfg.ssm_type == "mamba":
        reduced.update(d_state=8, conv_width=4)
    if cfg.attn_layer_period:
        reduced.update(attn_layer_period=4, attn_layer_offset=1, n_layers=4)
    if cfg.mrope_sections:
        reduced.update(mrope_sections=(2, 3, 3))
    return dataclasses.replace(cfg, **reduced)
