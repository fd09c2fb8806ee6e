"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1.

48L, d_model=5120, 40H (GQA kv=8), d_ff=8192, vocab=202048.
MoE: 16 routed experts top-1 + 1 shared expert every layer.  iRoPE: NoPE
(no rope) every 4th layer.  Early-fusion multimodal frontend stubbed
(text tokens only at the backbone boundary).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=True,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    nope_layer_period=4,
    rope_theta=500_000.0,
)
