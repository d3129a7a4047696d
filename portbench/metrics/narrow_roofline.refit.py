"""gemm_3xtf32_narrow_kernel's share of its roofline over the traced
fits: the least time of its launches (`gemm_bound`, bound by the bytes at
one output column) over its device time. A fit launches it once a panel
of p rows: b = psi y, (k, p) @ (p, 1)."""

from portbench.lib.roofline import gemm_bound, panels, share


def read(ctx):
    if ctx.traced is None or not ctx.counts.get("traced_fits"):
        return None
    cfg = ctx.config
    k = cfg["num_inducing"]
    a_fit = sum(gemm_bound(k, 1, p)[0]
                for p in panels(cfg["window_rows"], cfg["panel_rows"]))
    seconds, _ = ctx.traced.kernel_seconds("gemm_3xtf32_narrow")
    return share(ctx.counts["traced_fits"] * a_fit, seconds)
