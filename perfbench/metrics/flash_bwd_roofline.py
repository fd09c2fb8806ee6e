"""flash_bwd_roofline (%): the attention backward kernels' share of their
roofline.

The five products the backward needs over the causal pairs and its bytes
(``perfbench/work.py``'s ``flash_bwd_work``) give the least time of one
call: operations over 989 TFLOP/s (bf16 dense; 495 for float32 compute)
or bytes over 3.35 TB/s, whichever is longer.  It is set against the
device time per call of the ``flash_bwd`` class of
``kernel_classes.TRAIN_CLASSES``, over the calls of the whole steps
completed in the window.  Moves ``train_tokens_per_s``."""

from perfbench import kernel_classes, peaks


def read(ctx):
    d, v = ctx.driver, ctx.view
    if v is None or not d.n_units:
        return None
    w = d.work()
    calls = w["flash_bwd_calls"] * d.n_units
    t = sum(e - s for name, s, e in v.clipped()
            if kernel_classes.train_class(name) == "flash_bwd") / 1e9
    if t <= 0:
        return None
    rate = peaks.BF16_FLOPS if w["compute_dtype"] == "bfloat16" else \
        peaks.TF32_FLOPS
    bound = peaks.roofline_s(w["flash_bwd_flops"], w["flash_bwd_bytes"],
                             rate)
    return 100.0 * bound * calls / t
