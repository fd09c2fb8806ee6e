"""Baseline coded-computing schemes the paper compares against (Table II).

Ports ``repro/core/baselines.py``: the CONV, MDS, Polynomial, MatDot,
LCC, GLCC, SecPoly and BACC codes.  They register on import of
``repro_torch.core``, so the runtime constructs any of them through
``registry.build(name, **cfg)``:

    scheme   = registry.build("mds", n_workers=10, k_blocks=4)
    shards   = scheme.encode(X)            # (N, ...) one shard per worker
    results  = f applied per shard         # worker compute
    Y        = scheme.decode(results, responders)

Pair-coded schemes (Polynomial / SecPoly / MatDot) code (A, B) jointly
for the job C = A @ B and expose ``encode_pair`` instead of ``encode``.
Unlike SPACDC/BACC these classical codes have a hard *recovery threshold*:
``decode`` raises if ``len(responders) < scheme.recovery_threshold``.

Evaluation points are real, the coding matrices float64 numpy and the
decode inverses float64 ``np.linalg.inv``, as in the reference; every
encode/decode contraction runs through ``SchemeDefaults._combine``
(``kernels.ops.berrut_combine``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors), which casts the weights to float32.
LCC, GLCC and SecPoly draw their noise blocks from numpy's
``default_rng(seed)`` in float64 and round them to the payload's dtype,
exactly as the reference does, so their shards match its to float32.
SecPoly's ``use_kernel`` reaches its inner polynomial code (the
reference's flag stops at the wrapper and its inner code always takes the
default).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import berrut, registry
from .spacdc import pad_to_blocks

__all__ = ["UncodedScheme", "MDSCode", "PolynomialCode", "MatDotCode",
           "LCCScheme", "GLCCScheme", "SecPolyCode", "BACCScheme"]


def _cheb_points(n: int) -> np.ndarray:
    """Chebyshev nodes keep the real-field Vandermonde solves well-conditioned."""
    return berrut.chebyshev_points(n, kind=1)


def _lagrange_matrix(queries: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """(Q, n) exact Lagrange evaluation matrix (float64)."""
    q = np.asarray(queries, dtype=np.float64)[:, None]   # (Q, 1)
    x = np.asarray(nodes, dtype=np.float64)[None, :]     # (1, n)
    n = x.shape[1]
    out = np.ones((q.shape[0], n), dtype=np.float64)
    for j in range(n):
        for k in range(n):
            if k != j:
                out[:, j] *= (q[:, 0] - x[0, k]) / (x[0, j] - x[0, k])
    return out


def _lagrange_alphas(n_workers: int, beta: np.ndarray) -> np.ndarray:
    """The worker points of LCC/GLCC: Chebyshev-2 points on [-1.05, 1.05],
    each nudged by 1e-3 off any beta it meets."""
    alpha = berrut.chebyshev_points(n_workers, kind=2, lo=-1.05, hi=1.05)
    for i in range(len(alpha)):
        while np.any(np.abs(alpha[i] - beta) < 1e-9):
            alpha[i] += 1e-3
    return alpha


def _seeded_noise(rng: np.random.Generator, scale: float, shape,
                  like: torch.Tensor) -> torch.Tensor:
    """``scale`` x a float64 standard-normal draw of ``shape`` from
    ``rng``, rounded to ``like``'s dtype on its device."""
    noise = scale * rng.standard_normal(tuple(shape))
    return torch.from_numpy(noise).to(device=like.device, dtype=like.dtype)


def _no_noise_arg(name: str, noise) -> None:
    if noise is not None:
        raise ValueError(f"{name} draws its noise blocks from numpy's "
                         "default_rng(seed); pass noise=None")


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


@dataclasses.dataclass
class LCCScheme(_SchemeBase):
    """Lagrange Coded Computing [Yu et al. '19] for polynomial f of degree deg_f.

    K data blocks + T noise blocks Lagrange-encoded; threshold
    (K+T-1)*deg_f + 1.  Exact for polynomial f (tested with f(X)=X X^T).
    """
    n_workers: int
    k_blocks: int
    t_colluding: int = 0
    deg_f: int = 2
    noise_scale: float = 1.0
    seed: int = 0
    name: str = "lcc"

    def __post_init__(self):
        kt = self.k_blocks + self.t_colluding
        self.recovery_threshold = (kt - 1) * self.deg_f + 1
        if self.n_workers < self.recovery_threshold:
            raise ValueError("LCC needs N >= (K+T-1)deg_f + 1")
        self.beta = _cheb_points(kt)
        self.alpha = _lagrange_alphas(self.n_workers, self.beta)
        self.encoder = _lagrange_matrix(self.alpha, self.beta)   # (N, K+T)

    def encode(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        return self._combine(self.encoder, self.fused_blocks(x, noise))

    def fused_encoder_matrix(self):
        return self.encoder

    def fused_blocks(self, x, noise=None):
        _no_noise_arg(self.name, noise)
        x = pad_to_blocks(x, self.k_blocks)
        blocks = x.reshape((self.k_blocks, -1) + tuple(x.shape[1:]))
        if self.t_colluding:
            rng = np.random.default_rng(self.seed)
            blocks = torch.cat([blocks, _seeded_noise(
                rng, self.noise_scale,
                (self.t_colluding,) + tuple(blocks.shape[1:]), blocks)])
        return blocks

    def decode(self, results, responders: Sequence[int]):
        self._check(responders)
        r = self.recovery_threshold
        resp = np.asarray(responders[:r])
        # f(u(z)) has degree (K+T-1)*deg_f: interpolate it from r samples,
        # then evaluate at beta_0..beta_{K-1}
        eval_mat = _lagrange_matrix(self.beta[: self.k_blocks],
                                    self.alpha[resp])
        return self._combine(eval_mat, results[:r])


@dataclasses.dataclass
class GLCCScheme(_SchemeBase):
    """Group Lagrange Coded Computing [arXiv 2204.11168].

    LCC with the K data blocks partitioned into ``n_groups`` groups of
    ``per = K / n_groups`` blocks, each group Lagrange-encoded separately
    (with its own T noise blocks) over ONE shared (N, per+T) encoder.
    Grouping divides the interpolation degree, so the recovery threshold
    drops from ``(K+T-1)·deg_f + 1`` to ``(per+T-1)·deg_f + 1``, paid for
    with ``n_groups``× the per-worker computation and communication (each
    worker holds one coded block per group): the knob the adaptive
    controller (``runtime.adaptive``) sweeps.  ``n_groups=1`` is exactly
    LCC.
    """
    n_workers: int
    k_blocks: int
    t_colluding: int = 0
    deg_f: int = 2
    n_groups: int = 1
    noise_scale: float = 1.0
    seed: int = 0
    name: str = "glcc"

    def __post_init__(self):
        if self.n_groups < 1 or self.k_blocks % self.n_groups:
            raise ValueError(
                f"GLCC needs n_groups >= 1 dividing k_blocks, got "
                f"n_groups={self.n_groups}, K={self.k_blocks}")
        self.per_group = self.k_blocks // self.n_groups
        pt = self.per_group + self.t_colluding
        self.recovery_threshold = (pt - 1) * self.deg_f + 1
        if self.n_workers < self.recovery_threshold:
            raise ValueError("GLCC needs N >= (K/g + T - 1)deg_f + 1")
        self.beta = _cheb_points(pt)
        self.alpha = _lagrange_alphas(self.n_workers, self.beta)
        self.encoder = _lagrange_matrix(self.alpha, self.beta)  # (N, per+T)

    def _grouped_blocks(self, x):
        """Per-group (per+T, blk, ...) stacks; all groups' noise comes off
        ONE seeded stream in group order, so n_groups=1 draws exactly the
        LCC noise."""
        x = pad_to_blocks(x, self.k_blocks)
        blocks = x.reshape((self.k_blocks, -1) + tuple(x.shape[1:]))
        rng = np.random.default_rng(self.seed)
        per, out = self.per_group, []
        for gi in range(self.n_groups):
            gb = blocks[gi * per: (gi + 1) * per]
            if self.t_colluding:
                gb = torch.cat([gb, _seeded_noise(
                    rng, self.noise_scale,
                    (self.t_colluding,) + tuple(gb.shape[1:]), gb)])
            out.append(gb)
        return out

    def encode(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        # worker i's shard stacks its coded block from every group:
        # (N, n_groups·blk, ...), the g× communication cost of the
        # threshold reduction
        _no_noise_arg(self.name, noise)
        return torch.cat([self._combine(self.encoder, gb)
                          for gb in self._grouped_blocks(x)], dim=1)

    def decode(self, results, responders: Sequence[int]):
        self._check(responders)
        r = self.recovery_threshold
        resp = np.asarray(responders[:r])
        eval_mat = _lagrange_matrix(self.beta[: self.per_group],
                                    self.alpha[resp])
        res = results[:r]
        blk = res.shape[1] // self.n_groups
        res = res.reshape((r, self.n_groups, blk) + tuple(res.shape[2:]))
        return torch.cat([self._combine(eval_mat, res[:, gi])
                          for gi in range(self.n_groups)])   # (K, blk, ...)


@dataclasses.dataclass
class SecPolyCode(_SchemeBase):
    """Secure polynomial codes [Yang & Lee '19]: polynomial code + 1 random
    block appended to the A-polynomial for (T=1) privacy."""
    n_workers: int
    p: int
    q: int
    noise_scale: float = 1.0
    seed: int = 0
    name: str = "secpoly"
    pair_coded = True

    def __post_init__(self):
        self.inner = PolynomialCode(self.n_workers, self.p + 1, self.q)
        self.recovery_threshold = self.inner.recovery_threshold

    @property
    def use_kernel(self):
        return self.inner.use_kernel

    @use_kernel.setter
    def use_kernel(self, flag):
        self.inner.use_kernel = flag

    def encode_pair(self, a: torch.Tensor, b: torch.Tensor):
        a = pad_to_blocks(a, self.p)
        rng = np.random.default_rng(self.seed)
        noise = _seeded_noise(rng, self.noise_scale,
                              (a.shape[0] // self.p,) + tuple(a.shape[1:]), a)
        return self.inner.encode_pair(torch.cat([a, noise]), b)

    def decode(self, results, responders):
        out = self.inner.decode(results, responders)   # (p+1, q, ...)
        return out[: self.p]                           # drop the noise row

    def reconstruct_matmul(self, decoded, m: int, n: int):
        return _grid_reconstruct(decoded, m, n)


@dataclasses.dataclass
class BACCScheme(_SchemeBase):
    """Berrut Approximated Coded Computing [Jahani-Nezhad & Maddah-Ali '23].

    SPACDC minus the privacy noise and minus transmission encryption: the
    closest prior work, used as the approximation-quality baseline.
    """
    n_workers: int
    k_blocks: int
    name: str = "bacc"
    rateless = True

    def __post_init__(self):
        from .spacdc import SPACDCCode, SPACDCConfig
        self.recovery_threshold = 1  # rateless — any subset decodes
        self._code = SPACDCCode(SPACDCConfig(self.n_workers, self.k_blocks, 0))

    @property
    def use_kernel(self):
        return self._code.use_kernel

    @use_kernel.setter
    def use_kernel(self, flag):
        self._code.use_kernel = flag

    def encode(self, x, noise=None):
        return self._code.encode(x, noise)

    def decode(self, results, responders):
        return self._code.decode(results, np.asarray(responders))

    def decode_masked(self, results, mask):
        return self._code.decode_masked(results, mask)

    def decode_matrix_masked(self, mask):
        return self._code.decode_matrix_masked(mask)

    def fused_encoder_matrix(self):
        return self._code.fused_encoder_matrix()

    def fused_blocks(self, x, noise=None):
        return self._code.fused_blocks(x, noise)

    def prefix_decode_weights(self, arrival_order):
        return self._code.prefix_decode_weights(arrival_order)

    def anytime_proxy_weights(self, arrival_order, fh_degree: int = 2):
        return self._code.anytime_proxy_weights(arrival_order, fh_degree)


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


def _secpoly_factory(n_workers, k_blocks=None, p=None, q=None,
                     noise_scale=1.0, seed=0):
    return SecPolyCode(n_workers,
                       _require_blocks("secpoly", p, k_blocks or 2),
                       q or 1, noise_scale, seed)


def _matdot_factory(n_workers, k_blocks=None, p=None):
    return MatDotCode(n_workers, p=_require_blocks("matdot", p, k_blocks))


registry.register("conv", lambda n_workers: UncodedScheme(n_workers))
registry.register("mds", lambda n_workers, k_blocks: MDSCode(n_workers, k_blocks))
registry.register("polynomial", _polynomial_factory)
registry.register("matdot", _matdot_factory)
registry.register(
    "lcc",
    lambda n_workers, k_blocks, t_colluding=0, deg_f=2, noise_scale=1.0,
    seed=0: LCCScheme(n_workers, k_blocks, t_colluding, deg_f, noise_scale,
                      seed))
registry.register(
    "glcc",
    lambda n_workers, k_blocks, t_colluding=0, deg_f=2, n_groups=1,
    noise_scale=1.0, seed=0: GLCCScheme(n_workers, k_blocks, t_colluding,
                                        deg_f, n_groups, noise_scale, seed))
registry.register("secpoly", _secpoly_factory)
registry.register("bacc", lambda n_workers, k_blocks: BACCScheme(n_workers,
                                                                 k_blocks))
