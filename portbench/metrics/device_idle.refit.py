"""The share of the traced sub-window in which no kernel, copy or fill
ran on the card."""


def read(ctx):
    if ctx.traced is None:
        return None
    return 100.0 * (1.0 - ctx.traced.busy_s / ctx.traced.window_s)
