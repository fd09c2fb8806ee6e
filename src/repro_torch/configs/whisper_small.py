"""whisper-small [arXiv:2212.04356] — enc-dec audio backbone, conv frontend stubbed.

12L(enc)+12L(dec), d_model=768, 12H MHA (kv=12), d_ff=3072, vocab=51865.
GELU MLP, LayerNorm, learned/sinusoidal positions (we use sinusoidal for the
encoder frames, learned-equivalent rope-free decoder positions).  The audio
frontend (2×conv) is a stub: ``input_specs`` supplies precomputed frame
embeddings (B, S, d_model).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,              # decoder layers
    n_encoder_layers=12,
    encoder_decoder=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm_type="layernorm",
    rope_theta=0.0,           # whisper uses absolute positions, not rope
    frontend="audio_frames",
    dec_len_ratio=4,
)
