"""rwkv6-1.6b "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

24L, d_model=2048, d_ff=7168 (channel-mix), vocab=65536, head_dim=64 (32 heads).
Time-mix (WKV6) + channel-mix blocks; O(1) state -> runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,               # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm_type="rwkv6",
    rwkv_head_dim=64,
    activation="relu_sq",     # rwkv channel mix uses relu^2
    norm_type="layernorm",
    rope_theta=0.0,
)
