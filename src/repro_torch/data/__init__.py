"""Datasets: the synthetic MNIST of the paper's experiments and the
deterministic token pipeline of the LM trainer.

Ports ``repro/data``: ``synthetic_mnist``, ``TokenPipeline`` and
``make_batch``.
"""

from .mnist import synthetic_mnist
from .pipeline import TokenPipeline, make_batch

__all__ = ["TokenPipeline", "make_batch", "synthetic_mnist"]
