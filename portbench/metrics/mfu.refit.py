"""The Nystrom fit's share of the card's TF32 peak (495 TFLOP/s, the
fastest arithmetic 'high' runs on, so no reading can pass 100%) over the
traced fits: their model FLOPs over their seconds.

Model FLOPs of one fit of n rows, d features, m inducing rows and k = m
whitened directions, each product counted once whatever implements it (a
3xTF32 product as one), a symmetric product as its triangle, a product
with a triangular operand as its nonzero terms, a solve as n^2 a
right-hand side:
    K_mm (symmetric) m (m + 1) d; its Cholesky m^3 / 3; W = L^-T, m^3
    each panel of p rows: K_pm 2 p m d; psi = K_pm W (W upper
        triangular) p m (m + 1); C += psi^T psi (symmetric) p k (k + 1);
        b += psi^T y 2 p k
    (C + rI) Cholesky k^3 / 3; ic = L^-T, k^3; beta 4 k^2."""

from portbench.lib.roofline import PEAKS, panels


def fit_flops(n, d, m, panel):
    k = m
    total = m * (m + 1.0) * d + m ** 3 / 3.0 + float(m) ** 3
    for p in panels(n, panel):
        total += 2.0 * p * m * d + p * m * (m + 1.0) + p * k * (k + 1.0) \
            + 2.0 * p * k
    return total + k ** 3 / 3.0 + float(k) ** 3 + 4.0 * k * k


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    if ctx.traced is None or not fits:
        return None
    cfg = ctx.config
    flops = fits * fit_flops(cfg["window_rows"], ctx.counts["feature_dim"],
                             cfg["num_inducing"], cfg["panel_rows"])
    return 100.0 * flops / ctx.traced.window_s / PEAKS[cfg["mfu_peak"]]
