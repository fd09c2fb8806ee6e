"""coded_matmul_roofline (%): the ``coded_matmul`` kernel's share of its
roofline.

The least time for its work (the encode and the N products' operations
over 495 TFLOP/s, TF32 dense, or its bytes over 3.35 TB/s, whichever is
longer; ``perfbench/work.py``) over its device time per round, the
kernels of ``kernel_classes.CODED_MATMUL`` in the trace, one call a
round.  Moves ``round_ms``."""

from perfbench import kernel_classes, peaks


def read(ctx):
    d, v = ctx.driver, ctx.view
    if v is None or not d.n_units:
        return None
    per_call = v.kernel_s(kernel_classes.CODED_MATMUL) / d.n_units
    if per_call <= 0:
        return None
    w = d.work()
    bound = peaks.roofline_s(w["coded_matmul_flops"], w["coded_matmul_bytes"],
                             peaks.TF32_FLOPS)
    return 100.0 * bound / per_call
