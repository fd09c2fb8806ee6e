"""round_mfu (%): the whole round's share of the card's TF32 dense peak.

The round's operations from the shapes (encode, the N workers' products,
one K-row decode over the responders' results; ``perfbench/work.py``)
times the rounds completed in the traced window, over the window's wall
(host clock) and 495 TFLOP/s.  The count and the peak are the same whatever
implements the round.  Moves ``round_ms``."""

from perfbench import peaks


def read(ctx):
    d = ctx.driver
    if ctx.view is None or not d.n_units:
        return None
    wall = (d.t1_ns - d.t0_ns) / 1e9
    return 100.0 * d.work()["round_flops"] * d.n_units / wall / \
        peaks.TF32_FLOPS
