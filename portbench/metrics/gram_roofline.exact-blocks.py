"""Both Gram kernels' share of their roofline over the traced fits, at
the column-block fit's shapes: the least time of a fit's launches over
the device time of the Gram kernels (`gram_`). Block k of width w (the
fit's blocks of `block_columns` columns, the last narrower) launches
`gram_sym` on its (w, w) diagonal square and, below it, `gram_cross` on
the (n - e, w) panel of the rows that follow; each launch is bounded by
`roofline.pair_bound` of its shape (the rows read once, each output
written once, or the dot's FLOPs, whichever is longer)."""

from portbench.lib.roofline import pair_bound, share

GRAM = ("gram_", "kernel")


def fit_bound(n, d, width, dtype):
    """Seconds: the least time of one fit's Gram launches."""
    total = 0.0
    for s in range(0, n, width):
        e = min(s + width, n)
        total += pair_bound(e - s, e - s, d, dtype)[0]
        if e < n:
            total += pair_bound(n - e, e - s, d, dtype)[0]
    return total


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    width = ctx.counts.get("block_columns", 0)
    if ctx.traced is None or not fits or not width:
        return None
    cfg = ctx.config
    seconds, _ = ctx.traced.kernel_seconds(GRAM)
    return share(fits * fit_bound(cfg["window_rows"],
                                  ctx.counts["feature_dim"], width,
                                  cfg["dtype"]), seconds)
