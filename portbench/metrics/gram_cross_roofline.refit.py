"""gram_cross's share of its roofline over the traced fits: the least
time of its launches (`pair_bound`) over its device time. A fit launches
it for K_mm, (m, m), and once a panel of p rows, (p, m), one fp32 Gram of
d-wide rows each."""

from portbench.lib.roofline import pair_bound, panels, share

GRAM = ("gram_", "kernel")


def read(ctx):
    if ctx.traced is None or not ctx.counts.get("traced_fits"):
        return None
    cfg = ctx.config
    m, d, dt = cfg["num_inducing"], ctx.counts["feature_dim"], cfg["dtype"]
    a_fit = pair_bound(m, m, d, dt)[0] + sum(
        pair_bound(p, m, d, dt)[0]
        for p in panels(cfg["window_rows"], cfg["panel_rows"]))
    seconds, _ = ctx.traced.kernel_seconds(GRAM)
    return share(ctx.counts["traced_fits"] * a_fit, seconds)
