"""Privacy accounting for SPACDC over the reals (Thm 2/3 analogue).

Ports ``repro/core/privacy.py``.  The paper proves I(X̃_P ; X) = 0 over a
uniform finite field.  Over the reals with Gaussian noise blocks the exact
statement becomes a bounded mutual information: for a coded shard

    X̃_i = Σ_j  a_j X_j  +  Σ_t  b_t Z_t ,  Z_t ~ N(0, σ²)

the per-element leakage obeys the Gaussian-channel bound

    I(X̃_i ; X)  ≤  1/2 · log2(1 + SNR_i),
    SNR_i = (Σ_j a_j² · Var[X]) / (Σ_t b_t² · σ²)

so leakage → 0 as noise_scale → ∞.  The analytic bounds are host numpy on
the encoder matrix, as in the reference.  The empirical proxy draws its
noise trials from an explicit ``torch.Generator`` (the reference splits a
``jax.random`` key and maps the encode over the keys).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gaussian_mi_bound", "empirical_leakage", "min_noise_scale_for"]


def _enc(code) -> np.ndarray:
    return code.enc_matrix.detach().cpu().numpy()      # (N, K+T) float32


def gaussian_mi_bound(code, var_x: float = 1.0) -> np.ndarray:
    """(N,) upper bound in bits/element on I(X̃_i ; X) for each worker."""
    cfg = code.cfg
    enc = _enc(code)
    a2 = (enc[:, : cfg.k_blocks] ** 2).sum(axis=1) * var_x
    if cfg.t_colluding == 0:
        return np.full(cfg.n_workers, np.inf)
    b2 = (enc[:, cfg.k_blocks:] ** 2).sum(axis=1) * (cfg.noise_scale ** 2)
    return 0.5 * np.log2(1.0 + a2 / np.maximum(b2, 1e-30))


def min_noise_scale_for(code, bits: float, var_x: float = 1.0) -> float:
    """Smallest noise_scale achieving ≤ `bits` leakage for every worker."""
    cfg = code.cfg
    if cfg.t_colluding == 0:
        raise ValueError("need T >= 1 noise blocks for any privacy")
    enc = _enc(code)
    a2 = (enc[:, : cfg.k_blocks] ** 2).sum(axis=1) * var_x
    b2_unit = (enc[:, cfg.k_blocks:] ** 2).sum(axis=1)
    snr_target = 2.0 ** (2.0 * bits) - 1.0
    need = a2 / (snr_target * np.maximum(b2_unit, 1e-30))
    return float(np.sqrt(need.max()))


def empirical_leakage(code, x: torch.Tensor, generator: torch.Generator,
                      n_trials: int = 64) -> float:
    """Monte-Carlo proxy: max |corr| between any coded shard element and the
    matching data element across fresh noise draws from ``generator`` (on
    x's device).  → 0 as noise grows."""
    cfg = code.cfg
    blocks = code.split_blocks(x)                       # (K, blk, ...)
    shape = (n_trials, cfg.t_colluding) + tuple(blocks.shape[1:])
    noise = cfg.noise_scale * torch.randn(shape, generator=generator,
                                          device=x.device, dtype=x.dtype)
    shards = torch.stack([code.encode_blocks(blocks, noise[t])[0].reshape(-1)
                          for t in range(n_trials)])    # (trials, elems)
    data = blocks[0].reshape(-1)                        # (elems,)
    sc = shards - shards.mean(dim=0, keepdim=True)
    corr_num = (sc * (data - data.mean())[None, :]).mean(dim=0)
    denom = sc.std(dim=0, correction=0) * (data.std(correction=0) + 1e-9) \
        + 1e-12
    return float(torch.max(torch.abs(corr_num / denom)))
