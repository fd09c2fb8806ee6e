"""The work a cell's shapes need, counted once here: operations and bytes.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``flash_bwd_work``: ``chip_smoke.py:6173`` (``flash_bwd_work``).
* ``dense_param_count`` and ``model_flops_train``: the dense decoder-only
  branch of ``src/repro_torch/configs/base.py:126`` (``param_count``)
  and the ``train`` branch of ``src/repro_torch/launch/roofline_math.py:39``
  (``model_flops``); ``tests/test_perfbench_work.py`` holds them equal
  to the port's for phi3-mini.
* ``coded_round_work``: the fused round's operations and bytes by the
  convention of ``chip_smoke.py:482`` (``bound``) and PERF.md's kernel
  table: each input byte read once, each output byte written once; the
  decode counts only the responders' results, the rows it needs.
"""

from __future__ import annotations

import math


def coded_round_work(m: int, d: int, n: int, n_workers: int,
                     k_blocks: int, t_noise: int, n_responders: int,
                     elt: int = 4) -> dict:
    """One fused coded round of A (m, d) @ B (d, n): A cut into K blocks of
    ``blk`` rows, T noise blocks appended, encoded into N shards, N worker
    products (``coded_matmul``: encode and products in one launch), one
    K-row decode over the ``n_responders`` results it waits for
    (``berrut_combine``)."""
    blk = math.ceil(m / k_blocks)
    j = k_blocks + t_noise
    r = n_responders
    encode = 2 * n_workers * j * blk * d
    products = 2 * n_workers * blk * d * n
    decode = 2 * k_blocks * r * blk * n
    cm_bytes = elt * (m * d + t_noise * blk * d + d * n +
                      n_workers * blk * n + n_workers * j)
    dec_bytes = elt * (r * blk * n + k_blocks * r + k_blocks * blk * n)
    return {"round_flops": encode + products + decode,
            "coded_matmul_flops": encode + products,
            "coded_matmul_bytes": cm_bytes,
            "decode_flops": decode, "decode_bytes": dec_bytes}


def flash_bwd_work(b, sq, skv, h, kv, hd, hd_v, causal, elt,
                   products: int = 5) -> tuple:
    """(bytes, FLOP) of one attention backward: q, k, v, out and dout read
    and lse (float32) read once, dq, dk, dv written once; the products
    over the (query, key) pairs the mask keeps.  The function needs five
    (s and dq, dk over hd; dp and dv over hd_v)."""
    pairs = sum(min(skv, i + 1) for i in range(sq)) if causal else sq * skv
    nbytes = elt * (2 * b * sq * h * (hd + hd_v) +
                    2 * b * skv * kv * (hd + hd_v)) + 4 * b * sq * h
    per_pair = {5: 2 * (3 * hd + 2 * hd_v), 7: 2 * (4 * hd + 3 * hd_v),
                8: 2 * (5 * hd + 3 * hd_v)}[products]
    return nbytes, b * h * per_pair * pairs


def dense_param_count(cfg: dict) -> int:
    """Parameters of a dense decoder-only LM (GQA attention, SwiGLU or
    two-matrix FFN, untied or tied embeddings), as the port counts them."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hq, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    tied = cfg.get("tie_word_embeddings", False)
    mats = 3 if cfg.get("hidden_act", "silu") == "silu" else 2
    attn = d * hq * hd + 2 * d * kv * hd + hq * hd * d
    ffn = mats * d * cfg["intermediate_size"]
    emb = v * d * (1 if tied else 2)
    return emb + cfg["num_hidden_layers"] * (attn + ffn)


def model_flops_train(cfg: dict, seq: int, batch: int) -> float:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``
    tokens: 6 per non-embedding parameter and token, 6·d·V for the
    unembedding, and causal attention's 6·S(S+1)/2·H·hd per layer and
    sequence; no recomputation counted."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hq = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // hq
    tied = cfg.get("tie_word_embeddings", False)
    n_nonemb = dense_param_count(cfg) - v * d * (1 if tied else 2)
    tokens = batch * seq
    return float(tokens * (6 * n_nonemb + 6 * d * v) +
                 6 * hq * hd * cfg["num_hidden_layers"] * batch *
                 (seq * (seq + 1) // 2))
