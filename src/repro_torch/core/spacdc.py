"""SPACDC scheme (paper §V) — encode / distributed compute / decode.

Ports ``repro/core/spacdc.py``.  Pipeline (Algorithm 1):
  1. Data process: split X (m×d) into K row-blocks, append T i.i.d. noise
     blocks, Berrut-combine at N worker points alpha_i -> coded shards X̃_i.
  2. Task computing: worker i computes Ỹ_i = f(X̃_i).
  3. Result recovering: from any responder subset F, evaluate the Berrut
     interpolant over {(alpha_i, Ỹ_i)}_{i∈F} at beta_0..beta_{K-1}.

The encode/decode contraction runs through ``repro_torch.kernels.ops`` (the
hand-written CUDA kernel for CUDA tensors, the plain PyTorch version for
CPU tensors).

Noise: the reference draws its T noise blocks with
``jax.random.normal(PRNGKey(seed))`` on every draw, so every round of a
session sees the same noise.  The port keeps that behaviour with a
``torch.Generator`` on the payload's device, re-seeded from ``cfg.seed`` on
each draw.  Torch's numbers differ from JAX's, so :meth:`encode` and
:meth:`fused_blocks` take an explicit ``noise`` tensor: the parity tests
hand in the JAX-drawn noise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import berrut, registry

__all__ = ["SPACDCConfig", "SPACDCCode", "pad_to_blocks"]


def pad_to_blocks(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad rows so axis-0 is divisible by K (paper §V-B.1)."""
    rem = (-x.shape[0]) % k
    if rem:
        x = torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
    return x


@dataclasses.dataclass(frozen=True)
class SPACDCConfig:
    n_workers: int          # N
    k_blocks: int           # K
    t_colluding: int = 0    # T — number of noise blocks / colluding workers tolerated
    noise_scale: float = 1.0  # std of the i.i.d. noise blocks
    fh_degree: int = 0      # Floater–Hormann blending degree (0 = Berrut)
    seed: int = 0
    use_kernel: Optional[bool] = None  # None=kernel on CUDA, True=kernel, False=plain

    def __post_init__(self):
        if self.k_blocks < 1 or self.n_workers < 1:
            raise ValueError("need K >= 1, N >= 1")
        if self.t_colluding < 0:
            raise ValueError("T must be >= 0")


class SPACDCCode(registry.SchemeDefaults):
    """Encoder/decoder holding the node layout for (N, K, T); rateless
    (recovery threshold 1 — any responder subset decodes)."""

    name = "spacdc"
    rateless = True
    recovery_threshold = 1

    def __init__(self, cfg: SPACDCConfig, use_kernel: Optional[bool] = None):
        self.cfg = cfg
        self.use_kernel = cfg.use_kernel if use_kernel is None else use_kernel
        self.n_workers = cfg.n_workers
        self.k_blocks = cfg.k_blocks
        alphas, betas = berrut.default_alpha_beta(cfg.n_workers, cfg.k_blocks,
                                                  cfg.t_colluding)
        # float32, as the reference holds them (jnp default precision)
        self.alphas = torch.as_tensor(alphas, dtype=torch.float32)
        self.betas = torch.as_tensor(betas, dtype=torch.float32)
        # encoder matrix: the (K+T)-node basis at the alpha points (N, K+T)
        if cfg.fh_degree:
            bw = berrut.fh_weights(betas, cfg.fh_degree)
            self.enc_matrix = berrut.bary_weight_matrix(self.alphas,
                                                        self.betas, bw)
        else:
            self.enc_matrix = berrut.berrut_weight_matrix(self.alphas,
                                                          self.betas)
        # per-responder-set decode matrices recur every round — cache them
        # (bound per instance so the cache dies with the code object)
        self._decode_matrix_cached = functools.lru_cache(maxsize=256)(
            self._decode_matrix)
        self._loo_weights_cached = functools.lru_cache(maxsize=1024)(
            self._loo_weights)

    # ---------------------------------------------------------------- encode
    def make_noise(self, block_shape, dtype=torch.float32, device="cpu"):
        """(T, *block_shape) noise blocks: ``noise_scale`` × standard normal
        from a generator on ``device`` seeded with ``cfg.seed`` (every draw
        is the same, as in the reference)."""
        t = self.cfg.t_colluding
        shape = (t,) + tuple(block_shape)
        if t == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(self.cfg.seed)
        noise = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
        return (self.cfg.noise_scale * noise).to(dtype)

    def _stack_noise(self, blocks: torch.Tensor, noise) -> torch.Tensor:
        """blocks (K, ...) with the T noise blocks appended -> (K+T, ...)."""
        if noise is None:
            noise = self.make_noise(blocks.shape[1:], blocks.dtype,
                                    blocks.device)
        else:
            if not torch.is_tensor(noise):
                noise = torch.from_numpy(np.array(noise))   # a writable copy
            noise = noise.to(device=blocks.device, dtype=blocks.dtype)
            want = (self.cfg.t_colluding,) + tuple(blocks.shape[1:])
            if tuple(noise.shape) != want:
                raise ValueError(f"noise must have shape {want}, got "
                                 f"{tuple(noise.shape)}")
        return torch.cat([blocks, noise], dim=0)

    def split_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(m, ...) -> (K, m/K, ...), zero-padding if needed."""
        k = self.cfg.k_blocks
        x = pad_to_blocks(x, k)
        return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))

    def encode_blocks(self, blocks: torch.Tensor, noise=None) -> torch.Tensor:
        """blocks: (K, blk, ...) -> coded shards (N, blk, ...).  Appends T
        noise blocks (drawn, or ``noise`` when given)."""
        k = self.cfg.k_blocks
        if blocks.shape[0] != k:
            raise ValueError(f"expected {k} blocks, got {blocks.shape[0]}")
        return self._combine(self.enc_matrix, self._stack_noise(blocks, noise))

    def encode(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        """Full data-process phase: (m, d) -> (N, m/K, d)."""
        return self.encode_blocks(self.split_blocks(x), noise)

    # ------------------------------------------------------------ fused round
    def fused_encoder_matrix(self) -> torch.Tensor:
        return self.enc_matrix

    def fused_blocks(self, a: torch.Tensor, noise=None) -> torch.Tensor:
        """(m, d) -> (K+T, blk, d): split into K row-blocks + T noise blocks
        (drawn, or ``noise`` when given)."""
        return self._stack_noise(self.split_blocks(a), noise)

    # ---------------------------------------------------------------- decode
    def decode_matrix(self, responders: Sequence[int] | np.ndarray) -> torch.Tensor:
        """(K, |F|) decode matrix for a concrete responder index set F.

        The signs alternate over the surviving nodes in sorted order
        (Berrut's construction, the only pole-free reading of Eq. (18) with
        stragglers).  Cached per responder tuple.
        """
        resp = np.asarray(responders, dtype=np.int64)
        if resp.size == 0:
            raise ValueError("decode needs at least one responder")
        return self._decode_matrix_cached(tuple(resp.tolist()))

    def _decode_matrix(self, resp: tuple) -> torch.Tensor:
        nodes_np = self.alphas.numpy()[np.asarray(resp, dtype=np.int64)]
        betas = self.betas[: self.cfg.k_blocks]
        if self.cfg.fh_degree and len(resp) > self.cfg.fh_degree:
            bw = berrut.fh_weights(nodes_np, self.cfg.fh_degree)
            return berrut.bary_weight_matrix(betas, nodes_np, bw)
        rank = np.argsort(np.argsort(nodes_np))
        signs = np.where(rank % 2 == 0, 1.0, -1.0)
        return berrut.berrut_weight_matrix(betas, nodes_np, signs)

    def decode(self, results: torch.Tensor, responders) -> torch.Tensor:
        """results: (|F|, ...) worker outputs (ordered as ``responders``)
        -> (K, ...) approx f(X_i)."""
        return self._combine(self.decode_matrix(responders), results)

    def decode_matrix_masked(self, mask) -> torch.Tensor:
        """(K, N) float32 Berrut decode weights for a responder mask (N,).

        Computed exactly as the reference computes it (``spacdc.py:164``):
        float32 alphas and betas, argsort of the alphas, cumsum rank of the
        survivors, alternating signs.  Non-responders get weight 0 and the
        weights renormalize over the survivors.
        """
        mask = torch.as_tensor(mask).to(torch.float32)
        alphas = self.alphas.to(mask.device)
        betas = self.betas.to(mask.device)
        # rank of each *surviving* node in sorted(alpha) order -> sign
        order = torch.argsort(alphas, stable=True)
        rank_sorted = torch.cumsum(mask[order], dim=0) - 1.0
        rank = torch.zeros_like(mask).index_put_((order,), rank_sorted)
        signs = torch.where(torch.remainder(rank, 2.0) == 0.0, 1.0, -1.0) * mask
        diff = betas[: self.cfg.k_blocks, None] - alphas[None, :]   # (K, N)
        terms = signs / diff
        return terms / terms.sum(dim=-1, keepdim=True)

    def decode_masked(self, results: torch.Tensor, mask) -> torch.Tensor:
        """Decode results (N, ...) with a boolean/float responder mask (N,)."""
        return self._combine(self.decode_matrix_masked(mask), results)

    # ------------------------------------------------------ anytime decode
    def prefix_decode_weights(self, arrival_order):
        """(E, K, N) Berrut decode weights for every prefix of a concrete
        arrival order + all-True ready flags (rateless: every non-empty
        prefix decodes).  Each prefix reuses the cached :meth:`decode_matrix`
        of its sorted responder tuple, scattered into the worker axis."""
        order = np.asarray(arrival_order, dtype=np.int64)
        k = self.cfg.k_blocks
        weights = np.zeros((order.size, k, self.n_workers), np.float32)
        for p in range(1, order.size + 1):
            resp = np.sort(order[:p])
            weights[p - 1, :, resp] = self.decode_matrix(resp).numpy().T[
                : len(resp)]
        return weights, np.ones(order.size, bool)

    def anytime_proxy_weights(self, arrival_order, fh_degree: int = 2):
        """The embedded-pair proxy decoder: Floater–Hormann degree-d
        weights over the same prefixes.  FH converges an order faster than
        Berrut's d=0 interpolant, so ``|decode_d0 - decode_fh|`` estimates
        the d=0 decode's error without the true product.  Prefixes with
        ≤ d+1 nodes (where FH degenerates to Berrut) are flagged invalid.
        As in the reference, the FH weights are float64 over the float32
        nodes, and ``berrut.bary_weight_matrix`` evaluates in float32.
        """
        order = np.asarray(arrival_order, dtype=np.int64)
        k = self.cfg.k_blocks
        nodes_all = self.alphas.numpy().astype(np.float64)
        betas = self.betas.numpy().astype(np.float64)[:k]
        weights = np.zeros((order.size, k, self.n_workers), np.float32)
        valid = np.zeros(order.size, bool)
        for p in range(fh_degree + 2, order.size + 1):
            resp = np.sort(order[:p])
            nodes = nodes_all[resp]
            bw = berrut.fh_weights(nodes, fh_degree)
            mat = berrut.bary_weight_matrix(betas, nodes, bw).numpy()
            weights[p - 1, :, resp] = mat.T[: len(resp)]
            valid[p - 1] = True
        return weights, valid


    # ------------------------------------------------- Byzantine screening
    def _loo_weights(self, i: int, others: tuple) -> np.ndarray:
        """(|others|,) Berrut interpolation weights predicting worker i's
        value at alpha_i from the other responders' nodes (alternating sign
        by sorted rank, as in the decode matrix, evaluated at alpha_i
        instead of the betas), returned as float64.  Evaluated in float32
        as the reference evaluates them; the normalizing sum runs left to
        right, the order of XLA's CPU row sum up to 32 nodes, so the rows
        match the reference's bit for bit there."""
        alphas = self.alphas.numpy()
        nodes = alphas[np.asarray(others, dtype=np.int64)]
        rank = np.argsort(np.argsort(nodes.astype(np.float64)))
        signs = np.where(rank % 2 == 0, 1.0, -1.0).astype(np.float32)
        diff = (alphas[i] - nodes).astype(np.float32)
        hit = np.abs(diff) < 1e-12
        if hit.any():
            w = hit.astype(np.float32) / np.float32(max(hit.sum(), 1))
        else:
            terms = (signs / diff).astype(np.float32)
            w = terms / np.add.accumulate(terms, dtype=np.float32)[-1]
        return w.astype(np.float64)

    def decode_residuals(self, results, mask) -> np.ndarray:
        """Leave-one-out Berrut residuals (see ``SchemeDefaults``): worker
        i's result against the rational interpolant through the other
        responders evaluated at alpha_i, normalized by the MEDIAN responder
        norm.  The cached weight rows (responder sets recur every round)
        are stacked into one (R, R) matrix and applied in one float64
        product on the results' device (``registry._loo_scores``)."""
        mask = registry._host(mask).astype(bool)
        resp = np.flatnonzero(mask)
        if resp.size < 3:    # LOO prediction from < 2 nodes says nothing
            return np.zeros(mask.size, np.float64)
        weights = np.zeros((resp.size, resp.size), np.float64)
        for a, i in enumerate(resp):
            others = tuple(int(j) for j in resp if j != i)
            cols = [b for b in range(resp.size) if b != a]
            weights[a, cols] = self._loo_weights_cached(int(i), others)
        return registry._loo_scores(results, mask, resp, weights,
                                    np.ones(resp.size, bool))


registry.register(
    "spacdc",
    lambda n_workers, k_blocks, t_colluding=0, noise_scale=1.0, fh_degree=0,
    seed=0: SPACDCCode(SPACDCConfig(n_workers, k_blocks, t_colluding,
                                    noise_scale, fh_degree, seed)))
