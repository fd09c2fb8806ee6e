"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

27L, d_model=2048, 16H, MLA kv_lora_rank=512 (no q-lora in Lite),
qk_nope=128 / qk_rope=64 / v_head=128.  MoE: 64 routed experts top-6 +
2 shared, expert d_ff=1408; first layer dense with d_ff=10944.
(The pool line's "160 routed" is full V2; Lite per hf config has 64 routed,
matching the pool's own "MoE 64e top-6" bracket — documented in DESIGN.md.)
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense first layer
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,             # qk_nope + qk_rope
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
)
