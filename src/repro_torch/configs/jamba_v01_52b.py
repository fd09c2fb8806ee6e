"""jamba-v0.1-52b [arXiv:2403.19887; hf] — Mamba+attention 1:7 hybrid with MoE.

32L, d_model=4096, 32H (kv=8) on the attention layers, d_ff=14336.
Layer pattern: attention at layer index ≡ 4 (mod 8) — 4 attention layers,
28 mamba layers; MoE (16 experts top-2) every other layer (odd offset).
Mamba: d_state=16, conv=4, expand=2.  Hybrid -> runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    ssm_type="mamba",
    d_state=16,
    conv_width=4,
    expand=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    moe=True,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    rope_theta=0.0,           # jamba attention layers use no positional encoding
)
