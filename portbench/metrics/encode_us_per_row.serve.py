"""Host microseconds a row in the Estimator instance's encode_lines (the
native encoder and the scales), over the window: the harness's span
around each call, divided by the rows it encoded."""


def read(ctx):
    calls = ctx.spans.named("encode")
    rows = sum(s[3]["rows"] for s in calls)
    if not rows:
        return None
    return 1e6 * sum(s[2] - s[1] for s in calls) / rows
