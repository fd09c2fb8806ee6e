"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias,
parallel attention+FFN block, LayerNorm, tied embeddings.

40L, d_model=8192, 64H (kv=8), d_ff=22528, vocab=256000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    parallel_block=True,
    norm_type="layernorm",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)
