"""gram_sym's share of its roofline over the traced fits: the least time
of its launches (`sym_bound`) over the device time of the Gram kernel. A
fit launches it once, for the window's n rows: the (n, n) ridged Gram of
d-wide rows, written into the real block of the padded matrix."""

from portbench.lib.roofline import (HBM_BYTES_PER_S, ITEMSIZE, PEAKS,
                                    share)

GRAM = ("gram_", "kernel")


def sym_bound(n, d, dtype):
    """(seconds, 'bytes' or 'operations'): the least time of one symmetric
    Gram launch over n d-wide rows: the rows read once and all n^2
    entries written once (the kernel writes each tile and its mirror), or
    the dot's 2 d FLOPs an entry of the triangle, n (n + 1) d, at 67
    TFLOP/s, whichever is longer. dtype: 'float32' or 'float64'."""
    size = ITEMSIZE[dtype]
    t_bytes = (n * d + n * n) * size / HBM_BYTES_PER_S
    t_ops = n * (n + 1.0) * d / PEAKS["fp64" if size == 8 else "fp32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    if ctx.traced is None or not fits:
        return None
    cfg = ctx.config
    a_fit = sym_bound(cfg["window_rows"], ctx.counts["feature_dim"],
                      cfg["dtype"])[0]
    seconds, _ = ctx.traced.kernel_seconds(GRAM)
    return share(fits * a_fit, seconds)
