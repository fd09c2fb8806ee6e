"""train_mfu (%): the whole training step's share of the card's bf16
dense peak.

The step's model FLOPs from the shapes (``perfbench/work.py``'s frozen
copy of the port's ``model_flops``: 6 per parameter and token, causal
attention, no recomputation counted) times the whole steps completed in
the traced window, over the time from the window's start to the end of
the last of them (host clock) and 989 TFLOP/s.  Moves
``train_tokens_per_s``."""

from perfbench import peaks


def read(ctx):
    d = ctx.driver
    if ctx.view is None or not d.n_units:
        return None
    wall = (d.t1_ns - d.t0_ns) / 1e9
    return 100.0 * d.work()["step_model_flops"] * d.n_units / wall / \
        peaks.BF16_FLOPS
