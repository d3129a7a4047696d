"""The exact factor's share of its roofline over the traced fits: the
least time of the mathematics the model needs after the Gram, the
Cholesky of the window's n rows (n^3 / 3 FLOPs) and the two triangular
solves for alpha (2 n^2), at 67 TFLOP/s, over the device time of every
launch of the traced fits but the Gram kernel (`gram_`), copies
(`Memcpy`), fills (`Memset`) and PyTorch's own kernels (`at::native`:
the zero fill, the pad's diagonal, the concatenations, the exact
diagonal, the ridge's mean): what is left is cuSOLVER's factor and
cuBLAS's solves.

Only the n real rows count. The padded layout factors and solves at its
storage rows p (the pad's identity block is factored too), so while the
padding stands no reading can pass (n / p)^3: 38.1% at n = 10,800 and
p = 14,896."""

from portbench.lib.roofline import ITEMSIZE, PEAKS, share

LEFT_OUT = ("gram_", "Memcpy", "Memset", "at::native")


def factor_flops(n):
    n = float(n)
    return n ** 3 / 3.0 + 2.0 * n * n


def read(ctx):
    fits = ctx.counts.get("traced_fits", 0)
    if ctx.traced is None or not fits:
        return None
    cfg = ctx.config
    peak = PEAKS["fp64" if ITEMSIZE[cfg["dtype"]] == 8 else "fp32"]
    seconds = sum(e - s for name, s, e in ctx.traced.records
                  if not any(p in name for p in LEFT_OUT))
    return share(fits * factor_flops(cfg["window_rows"]) / peak, seconds)
