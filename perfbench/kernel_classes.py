"""Kernel classes by name, copied from ``chip_smoke.py``: ``STEP_CLASSES``
(line 1358, the coded round's kernels) and ``TRAIN_CLASSES`` (line 6167, a
training step's device split).  An activity belongs to the first class
one of whose lower-case patterns its lower-case name holds."""

CODED_MATMUL = ("encode_split_kernel", "split_b_kernel", "gemm_3xtf32_kernel")
BERRUT_COMBINE = ("berrut_stream",)

TRAIN_CLASSES = (("flash_fwd", ("flash_fwd",)),
                 ("flash_bwd", ("flash_bwd", "bwd_delta", "split_")),
                 ("cublas", ("gemm", "xmma", "cutlass", "nvjet")),
                 ("casts", ("copy_kernel",)))


def train_class(name: str) -> str:
    """The training class of one activity, ``rest`` if none."""
    low = name.lower()
    for key, pats in TRAIN_CLASSES:
        if any(p in low for p in pats):
            return key
    return "rest"
