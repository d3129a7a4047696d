"""Rows per call of the batcher's predict_fn: the lines the batcher
coalesced into one Estimator.predict, over the window (the harness's
span around each call)."""


def read(ctx):
    calls = ctx.spans.named("predict_fn")
    if not calls:
        return None
    return sum(s[3]["lines"] for s in calls) / len(calls)
