"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions) for the
perf-critical hot spots: the SPACDC Berrut contraction and the fused coded
matmul.  Ports ``repro/kernels``.  Importing this package builds nothing:
the kernels are compiled by ``nvcc`` at their first launch."""

from .ops import berrut_combine, coded_matmul, kernel_launches, prefix_decode
from . import ref

__all__ = ["berrut_combine", "coded_matmul", "kernel_launches",
           "prefix_decode", "ref"]
