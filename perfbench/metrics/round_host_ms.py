"""round_host_ms (ms): what the host adds to a round.

The traced window's wall per round less its device-busy time per round
(the union of every device activity's interval in the profiler's trace):
the plan, the launches, the stats and the waits in the api, engine and
plan layers.  Moves ``round_ms``."""


def read(ctx):
    d, v = ctx.driver, ctx.view
    if v is None or not d.n_units:
        return None
    return 1e3 * (v.window_s - v.busy_s) / d.n_units
