"""Deterministic, stateless synthetic token pipeline.

Ports ``repro/data/pipeline.py``: ``TokenPipeline.batch_at(step)`` is a
pure function of (seed, step), so a restarted job resumes mid-epoch on the
same batches with no data-loader state to snapshot.  Sequences are
Zipf-distributed token draws with a simple Markov structure, plus the
tokens shifted by one as targets.

The draws are the reference's numpy draws from ``SeedSequence([seed,
step])``, so the tokens and targets are bit-identical to its own.  Batches
are integer (and, for the encoder-decoder's frames, bfloat16) torch
tensors on the CPU: the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec

__all__ = ["TokenPipeline", "make_batch"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "targets"}: (global_batch, seq_len) int32 tensors."""
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # zipf-ish marginal + markov chain: tok_{t+1} = (tok_t * a + noise) % v
        base = rng.zipf(1.5, size=(b, s)).clip(1, v - 1)
        noise = rng.integers(0, 17, size=(b, s))
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = base[:, 0]
        for t in range(1, s):
            toks[:, t] = (toks[:, t - 1] * 31 + base[:, t] + noise[:, t]) % v
        tokens = toks.astype(np.int32)
        targets = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": torch.from_numpy(tokens),
                "targets": torch.from_numpy(targets)}


def make_batch(cfg: ModelConfig, shape: ShapeSpec, step: int = 0,
               seed: int = 0) -> dict:
    """A concrete batch of ``shape``'s kind: a train or prefill batch
    (``TokenPipeline``'s, with (3, B, S) ``mrope_positions`` for an M-RoPE
    config; for the encoder-decoder, (B, S, d) bfloat16 frames and
    decoder tokens and targets of ``max(S // dec_len_ratio, 16)``) or a
    decode batch of one token per row."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            sd = max(s // cfg.dec_len_ratio, 16)
            frames = rng.standard_normal((b, s, cfg.d_model))
            return {
                "frames": torch.from_numpy(frames).to(torch.bfloat16),
                "tokens": torch.from_numpy(
                    rng.integers(0, cfg.vocab_size, (b, sd)).astype(np.int32)),
                "targets": torch.from_numpy(
                    rng.integers(0, cfg.vocab_size, (b, sd)).astype(np.int32)),
            }
        batch = TokenPipeline(cfg.vocab_size, s, b, seed).batch_at(step)
        if cfg.mrope_sections:
            batch["mrope_positions"] = torch.from_numpy(
                np.broadcast_to(np.arange(s), (3, b, s)).astype(np.int32))
        return batch
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32))}
    if cfg.mrope_sections:
        batch["mrope_positions"] = torch.zeros((3, b, 1), dtype=torch.int32)
    return batch
