"""gemm_3xtf32_wgmma_kernel's share of its roofline over the traced fits:
the least time of its launches (`gemm_bound`) over its device time. A fit
launches it twice a panel of p rows, and each launch is bounded by the
mathematics it does, counted once (the kernel computes both in full):

    psi = K_pm W, (p, m) @ (m, k), W = chol(K_mm + jI)^-T upper
        triangular (k = m): p m (m + 1) FLOPs, not 2 p m k;
    C = psi^T psi, (k, p) @ (p, k), symmetric: its triangle,
        p k (k + 1) FLOPs, not 2 p k^2;

each at three TF32 products' cost (3 x FLOPs at 495 TFLOP/s), or the
operands read once and the output written once in fp32, whichever is
longer. A kernel that skipped the other triangle would read at most
100%."""

from portbench.lib.roofline import gemm_bound, panels, share


def read(ctx):
    if ctx.traced is None or not ctx.counts.get("traced_fits"):
        return None
    cfg = ctx.config
    m = k = cfg["num_inducing"]
    a_fit = sum(gemm_bound(p, k, m, flops=p * m * (m + 1.0))[0]
                + gemm_bound(k, k, p, flops=p * k * (k + 1.0))[0]
                for p in panels(cfg["window_rows"], cfg["panel_rows"]))
    seconds, _ = ctx.traced.kernel_seconds("gemm_3xtf32_wgmma")
    return share(ctx.counts["traced_fits"] * a_fit, seconds)
