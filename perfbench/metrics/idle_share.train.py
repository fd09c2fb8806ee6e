"""idle_share.train (%): the share of the traced window in which no
activity ran on the device.  Moves ``train_tokens_per_s``."""


def read(ctx):
    v = ctx.view
    if v is None or v.window_s <= 0:
        return None
    return 100.0 * (1.0 - v.busy_s / v.window_s)
