"""phi3-mini-3.8b [arXiv:2404.14219] — dense, RoPE + SwiGLU, MHA (kv=32).

32L, d_model=3072, 32H (kv=32), d_ff=8192, vocab=32064.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
)
