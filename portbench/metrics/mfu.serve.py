"""The exact predict's share of the card's fp64 peak over the traced
sub-window: the model FLOPs of the rows that reached the device there
(the rows the encode spans that ended in it encoded: memo and in-batch
repeats do not reach the device) over its seconds.

Model FLOPs of a row, at the real n train rows and d
features, pad slots and bucket padding not counted:
    2 n d (the cross Gram's dot) + 2 n (the mean) + n^2 (L^-1 k, a solve:
    n^2 a right-hand side) + 2 n (the variance's sum of squares),
written n^2 + 2 n d + 4 n."""

from portbench.lib.roofline import PEAKS


def read(ctx):
    if ctx.traced is None:
        return None
    t = ctx.traced
    rows = sum(s[3]["rows"] for s in ctx.spans.named("encode")
               if t.t0 <= s[2] <= t.t1)
    if not rows:
        return None
    n, d = ctx.counts["train_rows"], ctx.counts["feature_dim"]
    flops = rows * (n * n + 2.0 * n * d + 4.0 * n)
    return 100.0 * flops / t.window_s / PEAKS[ctx.config["mfu_peak"]]
