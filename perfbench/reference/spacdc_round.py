"""Plain reference of one fused SPACDC round (paper §V, Algorithm 1) for a
job A (m, d) @ B (d, n): split A into K row blocks, append the T noise
blocks, encode them into N shards with Berrut's weights at SPACDC's
nodes, compute every worker's product, decode the first N - S responders
of the round's straggler draw with Berrut's interpolant at the K data
nodes, and reassemble the rows.

Plain PyTorch and NumPy.  It imports neither ``jax``, the JAX package nor
the port, and takes nothing the program made: its node layout, weights
and responder sets are worked out here again.  Frozen copies, each from
the port's source, which states the paper's construction:

* ``chebyshev_points`` and ``node_layout``: ``src/repro_torch/core/
  berrut.py:44`` and ``:61`` (``default_alpha_beta``).
* ``paper_delays``: the ``"paper"`` mode of ``src/repro_torch/runtime/
  straggler.py:118-130`` (``StragglerModel.delays``), with its
  ``SeedSequence([seed, round])`` stream.
* The decode's signs alternate over the surviving nodes in sorted order
  (``src/repro_torch/core/spacdc.py:161``, Berrut's construction).

Weights are worked out in float64 and applied in float32.  Products run
in float32 with TF32 off (``precision="float32"``) or, for the control,
with every operand of every product rounded to TF32's 10-bit mantissa
(``precision="tf32"``: what the card's TF32 tensor cores compute).
"""

from __future__ import annotations

import numpy as np
import torch


def chebyshev_points(n: int, *, kind: int = 2, lo: float = -1.0,
                     hi: float = 1.0) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    if kind == 1:
        pts = np.cos((2.0 * k + 1.0) * np.pi / (2.0 * n))
    else:
        pts = np.cos(k * np.pi / max(n - 1, 1)) if n > 1 else np.zeros(1)
    return (lo + hi) / 2.0 + (hi - lo) / 2.0 * pts


def node_layout(n_workers: int, k_blocks: int, t_noise: int):
    """(alphas (N,), betas (K+T,)) float64: the K+T data and noise nodes at
    Chebyshev roots of [-1, 1], the N worker nodes at Chebyshev extrema of
    [-1.05, 1.05], a worker node that meets a data node moved by 1e-3."""
    betas = chebyshev_points(k_blocks + t_noise, kind=1)
    alphas = chebyshev_points(n_workers, kind=2, lo=-1.05, hi=1.05)
    for i in range(len(alphas)):
        while np.any(np.abs(alphas[i] - betas) < 1e-9):
            alphas[i] += 1e-3
    return alphas, betas


def berrut_matrix(queries: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """(Q, n) float64 Berrut weights: (-1)^rank / (x - x_i), rank the
    node's place in sorted order, each row normalized to sum 1."""
    rank = np.argsort(np.argsort(nodes))
    signs = np.where(rank % 2 == 0, 1.0, -1.0)
    terms = signs[None, :] / (queries[:, None] - nodes[None, :])
    return terms / terms.sum(axis=1, keepdims=True)


def encode_matrix(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """(N, K+T): every worker's shard as a combination of the blocks; the
    signs alternate over the blocks in the order the nodes are given."""
    signs = np.where(np.arange(betas.size) % 2 == 0, 1.0, -1.0)
    terms = signs[None, :] / (alphas[:, None] - betas[None, :])
    return terms / terms.sum(axis=1, keepdims=True)


def paper_delays(seed: int, round_idx: int, n: int, s: int,
                 delay_s: float, jitter_scale: float) -> np.ndarray:
    """Each worker's injected delay in one round: exponential jitter for
    all, ``delay_s`` (1 + U) more for S of them drawn without
    replacement."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, round_idx]))
    d = rng.exponential(jitter_scale, n)
    if s:
        idx = rng.choice(n, s, replace=False)
        d[idx] += delay_s * (1.0 + rng.random(s))
    return d


def responders(cfg: dict, seed: int, round_idx: int) -> np.ndarray:
    """The first N - S workers to arrive (FixedQuantile), sorted."""
    n, s = cfg["n_workers"], cfg["n_stragglers"]
    d = paper_delays(seed, round_idx, n, s, cfg["delay_s"],
                     cfg["jitter_scale"])
    return np.sort(np.argsort(d)[: max(n - s, 1)])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Round:
    """The reference of every round of one job: the encode and the N
    products once (they do not change from round to round), then each
    round's decode from its own responders."""

    def __init__(self, cfg: dict, a: torch.Tensor, b: torch.Tensor,
                 noise: torch.Tensor, seed: int,
                 precision: str = "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.m, self.n_out = cfg, seed, a.shape[0], \
            b.shape[1]
        self.k = cfg["k_blocks"]
        q = round_tf32 if precision == "tf32" else (lambda x: x)
        self.q = q
        self.alphas, self.betas = node_layout(cfg["n_workers"], self.k,
                                              cfg["t_colluding"])
        blk = -(-self.m // self.k)
        blocks = torch.zeros((self.k * blk, a.shape[1]), dtype=torch.float32,
                             device=a.device)
        blocks[: self.m] = a
        stacked = torch.cat([blocks.reshape(self.k, blk, -1),
                             noise.to(torch.float32)], dim=0)
        enc = torch.from_numpy(encode_matrix(self.alphas, self.betas)).to(
            device=a.device, dtype=torch.float32)
        shards = (q(enc) @ q(stacked.reshape(stacked.shape[0], -1))
                  ).reshape(-1, blk, a.shape[1])
        del stacked, blocks
        self.products = q(shards) @ q(b)               # (N, blk, n)
        self.blk = blk

    def expected(self, round_idx: int) -> torch.Tensor:
        """The round's (m, n) product as the reference decodes it."""
        resp = responders(self.cfg, self.seed, round_idx)
        w = berrut_matrix(self.betas[: self.k], self.alphas[resp])
        w = torch.from_numpy(w).to(device=self.products.device,
                                   dtype=torch.float32)
        idx = torch.from_numpy(resp).to(self.products.device)
        res = self.products.index_select(0, idx).reshape(resp.size, -1)
        out = self.q(w) @ self.q(res)
        return out.reshape(self.k * self.blk, self.n_out)[: self.m]


def rel_max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: a single wrong element shows."""
    if got.shape != want.shape:
        return float("inf")
    diff = (got.to(torch.float32) - want).abs().max()
    return float(diff) / max(float(want.abs().max()), 1e-30)
