"""The exact fit's share of the card's fp64 peak (67 TFLOP/s) over the
traced fits: their model FLOPs over the traced sub-window's seconds.

Model FLOPs of one fit of n rows (the window; pad rows are not counted,
whatever the padded layout factors) and d features, each product counted
once whatever implements it:
    the Gram (symmetric) as its triangle, n (n + 1) d;
    its Cholesky n^3 / 3;
    the two triangular solves for alpha, n^2 each (one right-hand side)."""

from portbench.lib.roofline import PEAKS


def fit_flops(n, d):
    n = float(n)
    return n * (n + 1.0) * d + n ** 3 / 3.0 + 2.0 * n * n


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    if ctx.traced is None or not fits:
        return None
    cfg = ctx.config
    flops = fits * fit_flops(cfg["window_rows"], ctx.counts["feature_dim"])
    return 100.0 * flops / ctx.traced.window_s / PEAKS[cfg["mfu_peak"]]
