"""qwen2-vl-72b [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

80L, d_model=8192, 64H (kv=8), d_ff=29568, vocab=152064.  The ViT frontend
(dynamic resolution) is a stub: ``input_specs`` provides text tokens plus the
(3, B, S) M-RoPE position streams (temporal/height/width — equal for text).
M-RoPE half-dim sections: (16, 24, 24).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision_patches",
)
