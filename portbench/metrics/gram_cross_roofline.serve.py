"""gram_cross's share of its roofline in the bucket replays of the traced
sub-window: each launch's least time (`pair_bound`: one (bucket, storage
rows) Gram of d-wide rows in the posterior's dtype) over its device time.
A launch's bucket is that of the rows its predict_fn call encoded: the
powers of two from 64 (the serving buckets of `serve/graphs.py`)."""

from portbench.lib.roofline import pair_bound, share

GRAM = ("gram_", "kernel")


def _bucket(rows):
    return max(64, 1 << (int(rows) - 1).bit_length())


def read(ctx):
    if ctx.traced is None:
        return None
    encodes = ctx.spans.named("encode")
    n, d = ctx.counts["storage_rows"], ctx.counts["feature_dim"]
    bound = seconds = 0.0
    for name, s, e in ctx.traced.records:
        if not all(p in name for p in GRAM):
            continue
        # the last encode before the launch is its call's
        before = [sp for sp in encodes if sp[2] <= s]
        if not before:
            continue
        rows = max(before, key=lambda sp: sp[2])[3]["rows"]
        bound += pair_bound(_bucket(rows), n, d, ctx.config["dtype"])[0]
        seconds += e - s
    return share(bound, seconds)
