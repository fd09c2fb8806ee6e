"""Baseline coded-computing schemes the paper compares against (Table II).

Ports the CONV, MDS, Polynomial and MatDot codes of
``repro/core/baselines.py``.  They register on import of
``repro_torch.core``, so the runtime constructs any of them through
``registry.build(name, **cfg)``:

    scheme   = registry.build("mds", n_workers=10, k_blocks=4)
    shards   = scheme.encode(X)            # (N, ...) one shard per worker
    results  = f applied per shard         # worker compute
    Y        = scheme.decode(results, responders)

Pair-coded schemes (Polynomial / MatDot) code (A, B) jointly for the job
C = A @ B and expose ``encode_pair`` instead of ``encode``.  Unlike SPACDC
these classical codes have a hard *recovery threshold*: ``decode`` raises
if ``len(responders) < scheme.recovery_threshold``.

Evaluation points are real, the coding matrices float64 numpy and the
decode inverses float64 ``np.linalg.inv``, as in the reference; every
encode/decode contraction runs through ``SchemeDefaults._combine``
(``kernels.ops.berrut_combine``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors), which casts the weights to float32.
LCC, GLCC, SecPoly, BACC and ``berrut_grad`` come in a later slice (see
ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import berrut, registry
from .spacdc import pad_to_blocks

__all__ = ["UncodedScheme", "MDSCode", "PolynomialCode", "MatDotCode"]


def _cheb_points(n: int) -> np.ndarray:
    """Chebyshev nodes keep the real-field Vandermonde solves well-conditioned."""
    return berrut.chebyshev_points(n, kind=1)


def _grid_reconstruct(decoded: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(p, q, m/p, n/q) block grid -> the (m, n) product (padding trimmed)."""
    p, q, mb, nb = decoded.shape
    out = decoded.swapaxes(1, 2).reshape(p * mb, q * nb)
    return out[:m, :n]


class _SchemeBase(registry.SchemeDefaults):
    n_workers: int
    recovery_threshold: int

    def _check(self, responders):
        if len(responders) < self.recovery_threshold:
            raise ValueError(
                f"{self.name}: {len(responders)} responders < recovery "
                f"threshold {self.recovery_threshold}")


@dataclasses.dataclass
class UncodedScheme(_SchemeBase):
    """CONV: X split into N blocks, no redundancy — must wait for everyone."""
    n_workers: int
    name: str = "conv"

    def __post_init__(self):
        self.recovery_threshold = self.n_workers

    def encode(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        x = pad_to_blocks(x, self.n_workers)
        return x.reshape((self.n_workers, -1) + tuple(x.shape[1:]))

    def fused_encoder_matrix(self):
        # encode is the identity over the N-block split; the fused path is
        # exact exactly when the mask is full — which wait_policy guarantees
        return np.eye(self.n_workers, dtype=np.float32)

    def fused_blocks(self, x, noise=None):
        return self.encode(x)

    def decode(self, results, responders: Sequence[int]):
        self._check(responders)
        order = torch.from_numpy(np.argsort(np.asarray(responders)))
        return results[order.to(results.device)]


@dataclasses.dataclass
class MDSCode(_SchemeBase):
    """(N, K) MDS code via real Vandermonde generator [Lee et al. '18].

    Linear tasks only (f(X) = X @ W): decode solves the K×K Vandermonde
    subsystem of the responding workers.
    """
    n_workers: int
    k_blocks: int
    name: str = "mds"

    def __post_init__(self):
        self.recovery_threshold = self.k_blocks
        self.points = _cheb_points(self.n_workers)
        # generator G[i, j] = x_i^j  (N × K)
        self.generator = np.vander(self.points, self.k_blocks, increasing=True)

    def encode(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        return self._combine(self.generator, self.fused_blocks(x))

    def fused_encoder_matrix(self):
        return self.generator

    def fused_blocks(self, x, noise=None):
        x = pad_to_blocks(x, self.k_blocks)
        return x.reshape((self.k_blocks, -1) + tuple(x.shape[1:]))

    def decode(self, results, responders: Sequence[int]):
        self._check(responders)
        resp = np.asarray(responders[: self.recovery_threshold])
        inv = np.linalg.inv(self.generator[resp])           # (K, K) float64
        return self._combine(inv, results[: self.recovery_threshold])


@dataclasses.dataclass
class PolynomialCode(_SchemeBase):
    """Polynomial codes [Yu et al. '17] for C = A @ B.

    A split into p row-blocks (A(x) = Σ A_i x^i), B into q column-blocks
    (B(x) = Σ B_j x^{j p}).  C(x) = A(x)B(x) has degree pq-1 → threshold pq.
    """
    n_workers: int
    p: int
    q: int
    name: str = "polynomial"
    pair_coded = True

    def __post_init__(self):
        self.recovery_threshold = self.p * self.q
        if self.n_workers < self.recovery_threshold:
            raise ValueError("polynomial code needs N >= p*q")
        self.points = _cheb_points(self.n_workers)

    def encode_pair(self, a: torch.Tensor, b: torch.Tensor):
        a = pad_to_blocks(a, self.p)
        bt = pad_to_blocks(b.T, self.q)  # split B by columns
        a_blocks = a.reshape((self.p, -1) + tuple(a.shape[1:]))
        b_blocks = bt.reshape((self.q, -1) + tuple(bt.shape[1:]))
        va = np.vander(self.points, self.p, increasing=True)          # x^i
        vb = np.vander(self.points ** self.p, self.q, increasing=True)  # x^{jp}
        return (self._combine(va, a_blocks),
                self._combine(vb, b_blocks).swapaxes(1, 2))

    def decode(self, results, responders: Sequence[int]):
        """results: (|F|, m/p, n/q) products A(x_i)B(x_i); returns (p, q, m/p, n/q)."""
        self._check(responders)
        r = self.recovery_threshold
        resp = np.asarray(responders[:r])
        vand = np.vander(self.points[resp], r, increasing=True)  # (r, r)
        coeffs = self._combine(np.linalg.inv(vand), results[:r])
        return coeffs.reshape((self.q, self.p) + tuple(coeffs.shape[1:])
                              ).swapaxes(0, 1)

    def reconstruct_matmul(self, decoded, m: int, n: int):
        return _grid_reconstruct(decoded, m, n)


@dataclasses.dataclass
class MatDotCode(_SchemeBase):
    """MatDot codes [Dutta et al. '20] for C = A @ B.

    A split by columns, B by rows into p blocks; A(x)=Σ A_i x^i,
    B(x)=Σ B_j x^{p-1-j}.  AB is the coefficient of x^{p-1} → threshold 2p-1,
    but each worker returns a full m×n product (high communication — the
    point the paper's Fig 6 makes).
    """
    n_workers: int
    p: int
    name: str = "matdot"
    pair_coded = True

    def __post_init__(self):
        self.recovery_threshold = 2 * self.p - 1
        if self.n_workers < self.recovery_threshold:
            raise ValueError("matdot needs N >= 2p-1")
        self.points = _cheb_points(self.n_workers)

    def encode_pair(self, a: torch.Tensor, b: torch.Tensor):
        at = pad_to_blocks(a.T, self.p)   # column split of A
        b2 = pad_to_blocks(b, self.p)     # row split of B
        a_blocks = at.reshape((self.p, -1) + tuple(at.shape[1:])).swapaxes(1, 2)
        b_blocks = b2.reshape((self.p, -1) + tuple(b2.shape[1:]))
        va = np.vander(self.points, self.p, increasing=True)
        vb = va[:, ::-1].copy()  # x^{p-1-j}
        return self._combine(va, a_blocks), self._combine(vb, b_blocks)

    def decode(self, results, responders: Sequence[int]):
        self._check(responders)
        r = self.recovery_threshold
        resp = np.asarray(responders[:r])
        vand = np.vander(self.points[resp], r, increasing=True)
        coeffs = self._combine(np.linalg.inv(vand), results[:r])
        return coeffs[self.p - 1]  # coefficient of x^{p-1} is A@B


# --------------------------------------------------------------------------
# registry entries: every factory takes the subset of the shared runtime
# config it understands; registry.build drops the rest.
# --------------------------------------------------------------------------

def _require_blocks(name: str, p, k_blocks):
    blocks = p or k_blocks
    if not blocks:
        raise ValueError(f"{name} needs k_blocks (or p) > 0")
    return blocks


def _polynomial_factory(n_workers, k_blocks=None, p=None, q=None):
    # k_blocks maps to a row split (p=k_blocks, q=1) so the shared runtime
    # config means the same block count here as for the data-coded schemes
    return PolynomialCode(n_workers,
                          _require_blocks("polynomial", p, k_blocks or 2),
                          q or 1)


def _matdot_factory(n_workers, k_blocks=None, p=None):
    return MatDotCode(n_workers, p=_require_blocks("matdot", p, k_blocks))


registry.register("conv", lambda n_workers: UncodedScheme(n_workers))
registry.register("mds", lambda n_workers, k_blocks: MDSCode(n_workers, k_blocks))
registry.register("polynomial", _polynomial_factory)
registry.register("matdot", _matdot_factory)
