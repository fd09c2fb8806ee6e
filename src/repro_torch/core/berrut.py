"""Berrut rational interpolation — the mathematical core of SPACDC.

Ports ``repro/core/berrut.py``.  The paper (Eq. 17/18) builds both its
encoder and decoder from Berrut's first rational interpolant [Berrut 1988]:

    r(x) = sum_i  w_i(x) * f_i,     w_i(x) = [(-1)^i / (x - x_i)] / sum_j (-1)^j / (x - x_j)

Key properties (tested against the reference):
  * r(x_k) = f_k exactly (interpolation at the nodes).
  * The weights sum to 1 for every x (partition of unity), so the decode is
    an affine combination of worker results.
  * With Chebyshev-distributed nodes the interpolant converges for smooth f.

Node layouts are float64 numpy, as in the reference.  Weight matrices are
float32 torch tensors, computed the way the reference computes them in
float32 (JAX's default precision), so both packages decode with the same
weights to within float32 rounding.  The CUDA kernel
``kernels/csrc/berrut_combine.cu`` implements :func:`combine` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "chebyshev_points",
    "default_alpha_beta",
    "fh_weights",
    "bary_weight_matrix",
    "berrut_weights",
    "berrut_weight_matrix",
    "combine",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def chebyshev_points(n: int, *, kind: int = 2, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Chebyshev points of the first (roots) or second (extrema) kind on [lo, hi]."""
    if n <= 0:
        raise ValueError(f"need n > 0, got {n}")
    k = np.arange(n, dtype=np.float64)
    if kind == 1:
        pts = np.cos((2.0 * k + 1.0) * np.pi / (2.0 * n))
    elif kind == 2:
        pts = np.cos(k * np.pi / max(n - 1, 1)) if n > 1 else np.zeros(1)
    else:
        raise ValueError(f"kind must be 1 or 2, got {kind}")
    # map [-1, 1] -> [lo, hi]
    return (lo + hi) / 2.0 + (hi - lo) / 2.0 * pts


def default_alpha_beta(n_workers: int, k_blocks: int, t_noise: int = 0):
    """Paper-style node layout: betas (K+T interpolation nodes carrying the
    data/noise blocks) at Chebyshev-1 roots, alphas (N worker evaluation
    points) at Chebyshev-2 points of a slightly larger interval, collisions
    nudged (Eq. 17 requires {alpha} ∩ {beta} = ∅).  Returns (alphas[N],
    betas[K+T]) float64 numpy."""
    kt = k_blocks + t_noise
    betas = chebyshev_points(kt, kind=1)
    alphas = chebyshev_points(n_workers, kind=2, lo=-1.05, hi=1.05)
    # resolve collisions deterministically (betas win; alphas shift by eps)
    eps = 1e-3
    for i in range(len(alphas)):
        while np.any(np.abs(alphas[i] - betas) < 1e-9):
            alphas[i] += eps
    if len(np.unique(alphas)) != len(alphas):
        raise ValueError("alpha points are not distinct")
    return alphas, betas


def fh_weights(nodes: np.ndarray, d: int = 0) -> np.ndarray:
    """Floater–Hormann barycentric weights of blending degree d (d=0 ≡
    Berrut's (-1)^i signs, the paper's construction).

    w_i = Σ_{k ∈ J_i} (-1)^k Π_{j=k..k+d, j≠i} 1/(x_i − x_j),
    J_i = {k : max(0, i−d) ≤ k ≤ min(i, n−1−d)}   [Floater & Hormann 2007]
    """
    x = np.asarray(nodes, dtype=np.float64)
    order = np.argsort(x)
    xs = x[order]
    n = len(xs)
    if d >= n:
        raise ValueError(f"blending degree {d} needs > {d} nodes")
    w_sorted = np.zeros(n)
    for i in range(n):
        total = 0.0
        for k in range(max(0, i - d), min(i, n - 1 - d) + 1):
            prod = 1.0
            for j in range(k, k + d + 1):
                if j != i:
                    prod /= (xs[i] - xs[j])
            total += (-1) ** k * prod
        w_sorted[i] = total
    w = np.empty(n)
    w[order] = w_sorted
    return w


def _normalize(terms: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Rows of ``terms`` normalized to sum 1; rows with an exact node hit
    become the (normalized) one-hot of the hit."""
    any_hit = hit.any(dim=-1, keepdim=True)
    w_reg = terms / terms.sum(dim=-1, keepdim=True)
    w_hit = hit.to(w_reg.dtype)
    w_hit = w_hit / torch.clamp(w_hit.sum(dim=-1, keepdim=True), min=1.0)
    return torch.where(any_hit, w_hit, w_reg)


def bary_weight_matrix(queries, nodes, bary_w) -> torch.Tensor:
    """(Q, n) float32 barycentric evaluation matrix for explicit weights."""
    diff = _f32(queries)[..., None] - _f32(nodes)[None, :]
    hit = diff.abs() < 1e-12
    terms = _f32(bary_w)[None, :] / torch.where(hit, torch.ones_like(diff),
                                                diff)
    return _normalize(terms, hit)


def berrut_weights(x, nodes, signs=None) -> torch.Tensor:
    """Berrut basis l_i(x) for scalar/batched x over given nodes.

    x: (...,) query points.  nodes: (n,).  Returns (..., n) float32 weights
    that sum to 1 along the last axis.  ``signs`` lets callers pass the
    (-1)^i signs of a *parent* node set when evaluating on a subset (the
    straggler case, Eq. (18)'s i ∈ F).
    """
    nodes = _f32(nodes)
    n = nodes.shape[-1]
    if signs is None:
        signs = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    diff = _f32(x)[..., None] - nodes
    # guard exact node hits: Berrut weights degenerate to a one-hot there
    hit = diff.abs() < 1e-12
    terms = _f32(signs) / torch.where(hit, torch.ones_like(diff), diff)
    return _normalize(terms, hit)


def berrut_weight_matrix(queries, nodes, signs=None) -> torch.Tensor:
    """(Q, n) matrix W with W[q, i] = l_i(query_q). Rows sum to 1."""
    return berrut_weights(queries, nodes, signs)


def combine(weights: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Weighted combination out[q] = sum_j W[q, j] * blocks[j], the plain
    contraction (the schemes route theirs through ``kernels.ops``).

    weights: (Q, J); blocks: (J, ...) -> (Q, ...).  Accumulates in f32
    regardless of block dtype.
    """
    j = blocks.shape[0]
    flat = blocks.reshape(j, -1).to(torch.float32)
    out = torch.matmul(_f32(weights).to(blocks.device), flat)
    return out.reshape((out.shape[0],) + tuple(blocks.shape[1:])).to(
        blocks.dtype)

