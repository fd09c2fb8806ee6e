"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the denominators
of every share of a peak or a roofline the benchmark reports.  The same
whatever implements the work, so a method that runs faster reads a
larger share and none can pass 100%."""

TF32_FLOPS = 495e12          # TF32 tensor cores, dense
BF16_FLOPS = 989e12          # bf16 tensor cores, dense
FP32_FLOPS = 67e12           # float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12    # 80 GB HBM3


def roofline_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time for the work: operations over the rate or bytes over
    HBM's bandwidth, whichever is longer."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)
