"""train_elementwise_ms (ms): device time per step of everything outside
the flash kernels, the GEMMs and the casts (the ``rest`` class of
``kernel_classes.TRAIN_CLASSES``): norms, RoPE, SwiGLU, the loss, the
gradient sums, AdamW, copies and sets.  From the trace of the whole
steps completed in the window.  Moves ``train_tokens_per_s``."""

from perfbench import kernel_classes


def read(ctx):
    d, v = ctx.driver, ctx.view
    if v is None or not d.n_units:
        return None
    rest = sum(e - s for name, s, e in v.clipped()
               if kernel_classes.train_class(name) == "rest")
    return rest / 1e6 / d.n_units
