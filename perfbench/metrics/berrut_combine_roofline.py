"""berrut_combine_roofline (%): the decode's ``berrut_combine`` kernel's
share of its roofline.

Its bytes (the N - S responders' results and their weights read once,
the K decoded blocks written once; ``perfbench/work.py``) over 3.35
TB/s, against its device
time per round in the trace (``kernel_classes.BERRUT_COMBINE``, one
call a round).  Moves ``round_ms``."""

from perfbench import kernel_classes, peaks


def read(ctx):
    d, v = ctx.driver, ctx.view
    if v is None or not d.n_units:
        return None
    per_call = v.kernel_s(kernel_classes.BERRUT_COMBINE) / d.n_units
    if per_call <= 0:
        return None
    w = d.work()
    bound = peaks.roofline_s(w["decode_flops"], w["decode_bytes"],
                             peaks.FP32_FLOPS)
    return 100.0 * bound / per_call
