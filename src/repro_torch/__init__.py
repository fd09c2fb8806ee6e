"""The SPACDC system ported to PyTorch and CUDA on an NVIDIA H100.

``repro_torch`` mirrors the JAX package ``repro`` module for module
(``repro_torch/core/spacdc.py`` ports ``repro/core/spacdc.py``, and so on);
each module's docstring names its reference.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  Its kernels are written by
hand in CUDA C++ for ``sm_90a`` and built with ``nvcc`` at first use.

Importing this package imports nothing else; the public surface is
``repro_torch.api`` (``ClusterSpec``, ``Session``).
"""
