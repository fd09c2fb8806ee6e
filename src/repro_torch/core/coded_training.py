"""SPACDC applied to distributed training: the paper's SPACDC-DL (§VI).

Ports ``coded_backprop_encode`` and ``coded_backprop_decode`` of
``repro/core/coded_training.py``: the layer-weight matrix Θ^l is split into
K row-blocks, Berrut-encoded with T noise blocks, and N workers compute the
backward product f_δ(Θ̃) = Θ̃^T δ^{l+1} ⊙ σ'(τ^l) on coded blocks; the
master decodes δ^l ≈ ℵ(ξ_i) from whichever workers respond.  The TPU-pod
half of the reference (``BerrutGradientCode``, ``coded_psum``) needs
``torch.distributed`` and comes in a later slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

__all__ = ["coded_backprop_encode", "coded_backprop_decode"]


def coded_backprop_encode(code, theta_t: torch.Tensor,
                          noise=None) -> torch.Tensor:
    """Encode (Θ^l)^T row-blocks into N coded weight shards (Eq. 25).
    ``noise`` optionally supplies the T noise blocks (see
    ``SPACDCCode.encode``)."""
    return code.encode(theta_t, noise)


def coded_backprop_decode(code, partials: torch.Tensor, responders,
                          sigma_prime: torch.Tensor) -> torch.Tensor:
    """Decode worker partial products and apply the σ' Hadamard (Eq. 26).

    partials: (|F|, rows/K, batch) worker results Θ̃_i^T δ.
    sigma_prime: (rows, batch) activation derivative at layer l.
    Returns δ^l ≈ (Θ^l)^T δ^{l+1} ⊙ σ'(τ^l)  with shape (rows, batch).
    """
    decoded = code.decode(partials, responders)      # (K, rows/K, batch)
    rows = sigma_prime.shape[0]
    flat = decoded.reshape((-1,) + tuple(decoded.shape[2:]))[:rows]
    return flat * sigma_prime
