"""Programs put in the program's place for the readings that limits are
set from (`control.py --side <name>=<seeds>`) and for the tests: the
faults each cell can have, planted in the program, and the witness of
the refit cell's gaps. Each takes the runner and returns what its
`program_*` method returns: an Estimator, or a fit of host rows.
"""

import numpy as np


def altered_answer(runner):
    """Serving: every eighth answer of each batch off by 0.01 (log2)."""
    est = runner.program_estimator()
    inner = est.predict

    def predict(lines):
        mean, std = inner(lines)
        mean = np.array(mean)
        mean[::8] += 0.01
        return mean, std
    est.predict = predict
    return est


def stale_fit(runner):
    """Refit: each fit returns the state of the fit before it."""
    fit, last = runner.program_fit(), []

    def stale(x, y):
        post = fit(x, y)
        out = last[0] if last else post
        last[:] = [post]
        return out
    return stale


def half_window(runner):
    """Refit: half of the window left out, the fit taken over the rest."""
    fit = runner.program_fit()
    return lambda x, y: fit(x[::2], y[::2])


def beta_off(runner):
    """Refit: the whitened weights off by 25% where the fit makes them."""
    fit = runner.program_fit()

    def altered(x, y):
        post = fit(x, y)
        post.beta_w = post.beta_w * 1.25
        return post
    return altered


def b_panel(runner):
    """Refit (Nystrom tier): the first panel's b = psi y scaled by 1.05
    where the fit adds it, before the finalize solves for the weights."""
    from nngp_tpu_torch.gp import nystrom

    fit, inner = runner.program_fit(), nystrom._panel_deltas
    first = [True]

    def deltas(*args, **kwargs):
        out = inner(*args, **kwargs)
        if first[0]:
            first[0] = False
            out = (out[0], out[1] * 1.05) + tuple(out[2:])
        return out

    def faulty(x, y):
        first[0] = True
        nystrom._panel_deltas = deltas
        try:
            return fit(x, y)
        finally:
            nystrom._panel_deltas = inner
    return faulty


def witness_fp32(runner):
    """Refit (Nystrom tier): the reference fit in the program's place with
    fp32 kernel entries and fp32 products (no TF32), fp64 whitening and
    solve: the program's arithmetic without its 3xTF32 products, to show
    what the fp32 model alone reads against the fp64 one."""
    from portbench.kinds.rolling_refit import reference_in_place

    return reference_in_place(runner.cfg, dtype="float32",
                              tf32=False)(runner)
