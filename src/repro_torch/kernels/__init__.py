"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions) for the
perf-critical hot spots: the SPACDC Berrut contraction, the fused coded
matmul, the MEA-ECC mask add and the models' flash attention.  Ports
``repro/kernels``.  Importing this package builds nothing: the kernels are
compiled by ``nvcc`` at their first launch."""

from .ops import (berrut_combine, coded_matmul, encrypted_coded_matmul,
                  flash_attention, fused_wire, kernel_launches, mask_add,
                  mea_decrypt_core, mea_encrypt_core, prefix_decode)
from . import ref

__all__ = ["berrut_combine", "coded_matmul", "encrypted_coded_matmul",
           "flash_attention", "fused_wire", "kernel_launches", "mask_add",
           "mea_decrypt_core", "mea_encrypt_core", "prefix_decode", "ref"]
