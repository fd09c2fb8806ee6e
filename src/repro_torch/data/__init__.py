"""Datasets for the paper's experiments.

Ports ``synthetic_mnist`` of ``repro/data``; the token pipeline
(``data/pipeline.py``) comes with the training plumbing (see ROADMAP.md).
"""

from .mnist import synthetic_mnist

__all__ = ["synthetic_mnist"]
