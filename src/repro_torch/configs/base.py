"""Model/shape configuration system.

A copy of ``repro/configs/base.py``: the config dataclasses are data, and a
spec must mean the same thing in both packages, so the port keeps its own
copy instead of importing the JAX package.

Every assigned architecture is a ``ModelConfig`` instance in its own
``src/repro_torch/configs/<id>.py``; the registry in ``__init__`` resolves
``--arch <id>``.  ``ShapeSpec`` encodes the four assigned input shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "pad_to"]


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # --- attention flavor ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim sections
    nope_layer_period: int = 0             # llama4 iRoPE: no rope every Nth layer
    attn_logit_softcap: float = 0.0

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1     # MoE every Nth layer ...
    moe_layer_offset: int = 0     # ... starting at this offset
    first_dense_layers: int = 0   # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_type: str = ""            # "rwkv6" | "mamba" | ""
    d_state: int = 16
    conv_width: int = 4
    expand: int = 2               # mamba d_inner = expand * d_model
    rwkv_head_dim: int = 64
    attn_layer_period: int = 0    # jamba: 1 attention layer per this many
    attn_layer_offset: int = 0

    # --- encoder-decoder ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    dec_len_ratio: int = 4        # decoder len = seq_len // ratio (whisper)

    # --- block / numerics ---
    activation: str = "swiglu"    # swiglu | gelu
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    parallel_block: bool = False  # command-r: attn and ffn in parallel
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    frontend: str = ""            # "" | audio_frames | vision_patches
    norm_eps: float = 1e-5

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""      # "" = compute dtype; "int8" = quantized
                                  # cache with per-(token, kv-head) scales

    # --- distribution knobs (overridden by the launcher) ---
    pad_heads_to: int = 1         # pad n_heads to a multiple of this (TP width)
    remat: bool = True
    scan_layers: bool = True
    fsdp_in_scan: bool = False    # unshard (all-gather) weights per layer
                                  # group inside the scan, in compute dtype —
                                  # FSDP×TP 2D sharding for >10B archs
    seq_shard_activations: bool = False  # sequence parallelism: residual
                                  # stream sharded over `model` between
                                  # blocks (remat carries /TP; AR -> RS+AG)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        return pad_to(self.n_heads, self.pad_heads_to)

    @property
    def n_kv_heads_padded(self) -> int:
        """MHA (kv == q) pads kv alongside q so GQA grouping stays exact."""
        if self.n_kv_heads == self.n_heads:
            return self.n_heads_padded
        return self.n_kv_heads

    def is_moe_layer(self, idx: int) -> bool:
        if not self.moe:
            return False
        if idx < self.first_dense_layers:
            return False
        return (idx % self.moe_layer_period) == self.moe_layer_offset % self.moe_layer_period

    def is_attn_layer(self, idx: int) -> bool:
        """Hybrid archs: which layers are attention (rest are SSM)."""
        if self.attn_layer_period == 0:
            return self.ssm_type == ""
        return (idx % self.attn_layer_period) == self.attn_layer_offset

    def is_nope_layer(self, idx: int) -> bool:
        return self.nope_layer_period > 0 and (idx + 1) % self.nope_layer_period == 0

    # --- parameter counting for MODEL_FLOPS (6·N·D / 2·N·D) --------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim_
        hq = self.n_heads_padded
        kv = self.n_kv_heads
        total = 0
        emb = self.vocab_size * d
        total += emb * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.mla:
                q = d * hq * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                ckv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
                up = self.kv_lora_rank * hq * (self.qk_nope_head_dim + self.v_head_dim)
                o = hq * self.v_head_dim * d
                return q + ckv + up + o
            return d * hq * hd + 2 * d * kv * hd + hq * hd * d

        def dense_ffn(ff):
            mats = 3 if self.activation == "swiglu" else 2
            return mats * d * ff

        def moe_ffn(active: bool):
            ff = self.moe_d_ff or self.d_ff
            per = dense_ffn(ff) / (3 if self.activation == "swiglu" else 2) * \
                (3 if self.activation == "swiglu" else 2)
            n_e = (self.top_k if active else self.n_experts)
            return per * n_e + per * self.n_shared_experts + d * self.n_experts

        def ssm_params():
            if self.ssm_type == "rwkv6":
                dh = d  # r,k,v,g,w projections + output
                return 5 * d * dh + dh * d + dense_ffn(self.d_ff) // (3 if self.activation == "swiglu" else 2) * 2
            if self.ssm_type == "mamba":
                din = self.expand * d
                return d * 2 * din + din * self.conv_width + din * (2 * self.d_state + 1) + \
                    din * self.d_state + din * d
            return 0

        layers = self.n_layers + (self.n_encoder_layers if self.encoder_decoder else 0)
        for i in range(layers):
            enc_layer = self.encoder_decoder and i >= self.n_layers
            if not enc_layer and self.ssm_type and not self.is_attn_layer(i):
                total += ssm_params()
            else:
                total += attn_params()
                if self.encoder_decoder and not enc_layer:
                    total += attn_params()  # cross attention
            if self.ssm_type == "rwkv6":
                continue  # channel mix counted inside ssm_params
            if self.is_moe_layer(i) and not enc_layer:
                total += int(moe_ffn(active_only))
            else:
                total += dense_ffn(self.d_ff)
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
