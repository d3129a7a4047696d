"""Forget(extend) against the fit on fp32 moments, in the port and in the
JAX package, on the CPU (ROADMAP Queue C, C5).

Moments are row sums, so forget(extend(rows)) is the fit in exact
arithmetic; in fp32, (C + P) - P is not C, and the whitening amplifies the
rounding. Neither package holds the 1e-6 of the largest mean that df64
moments hold (`chip_smoke.py` phase 8). With the same synth6 rows (chunk
norm), inducing rows, ridge and extend rows, the two packages reached
8.9e-5 (JAX) and 1.0e-4 (the port) of the largest mean over six sets of
600 extend lines and one of 1,000 at m = 2,048, and the port's worst set
was 2.4x JAX's on one of them and below it on others: no fault of the
port's. `chip_smoke.py` phase 17 (e) holds the card to the bound the two
share, FORGET_FP32_BOUND = 2e-4, twice the larger.

Here the same protocol runs at m = 256 (m = 2,048 takes ~30 s a set on
the CPU), on three sets of 600 lines, under 'highest' and 'high' (JAX's
'high' is full fp32 on the CPU): both packages stay within that bound, and
the port's worst set within 4x JAX's (1.9x measured: 2.4e-6 against
1.2e-6 under 'highest', 2.7e-6 under 'high'), which a fault in the port's
accumulation or its solve stage would exceed.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import nngp_tpu.gp.nystrom as JN
from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.serve import Estimator
from tests.test_torch_common import jax_spec

M = 256
SETS, SET_LINES = 3, 600
PORT_OVER_JAX = 4.0


@pytest.fixture(scope="module")
def synth6(tmp_path_factory):
    """The synth6 train rows and three extend sets, encoded by the port's
    Estimator (chunk_norm, fp32), its inducing rows, ridge and test rows."""
    train, test_labeled, val = chip_smoke.synth6_lines()
    test, _ = chip_smoke.synth6_test(test_labeled)
    tmp = tmp_path_factory.mktemp("forget")
    with contextlib.redirect_stdout(io.StringIO()):
        est = Estimator("synth6", None,
                        chip_smoke.write_train_dir(str(tmp), train),
                        stats_dir=chip_smoke.SYNTH6_STATS, dtype=np.float32,
                        chunk_norm=True, nystrom_m=M, device="cpu")

    def encoded(lines, kind):
        x, cards = est._encode_labeled_lines(lines, kind)
        return x, np.log2(cards).reshape(-1, 1).astype(np.float32)

    base = est.posterior
    return {"fit": encoded(train, "fit"),
            "sets": [encoded(val[i * SET_LINES:(i + 1) * SET_LINES],
                             "extend") for i in range(SETS)],
            "test": est.encode_lines(test), "spec": est.spec,
            "rows": (base.x_m * base.input_scale).numpy(),
            "scale": float(base.input_scale), "reg": float(base.reg)}


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fp32_moment_forget_extend_holds_the_bound_both_packages_share(
        synth6, precision):
    """max |forget(extend(set)) - fit| / max |fit| of the test means, each
    package against its own fit, over the extend sets."""
    kw = dict(inducing_rows=synth6["rows"], input_scale=synth6["scale"],
              diag_reg=synth6["reg"], diag_reg_absolute_scale=True,
              precision=precision)
    x, y = synth6["fit"]
    xt = synth6["test"]
    post = fit_nystrom(synth6["spec"], x, y, device="cpu", **kw)
    jpost = JN.fit_nystrom(jax_spec(synth6["spec"]), jnp.asarray(x),
                           jnp.asarray(y), **kw)
    assert post.moments == jpost.moments == "fp32"
    fit_mean = post.predict_mean_std_chunked(xt)[0]
    jfit_mean = np.asarray(jpost.predict_mean_std(jnp.asarray(xt))[0])
    port, ref = [], []
    for xn, yn in synth6["sets"]:
        back = post.extend(xn, yn).forget(xn, yn)
        port.append(_rel(back.predict_mean_std_chunked(xt)[0], fit_mean))
        jxn, jyn = jnp.asarray(xn), jnp.asarray(yn)
        jback = jpost.extend(jxn, jyn).forget(jxn, jyn)
        ref.append(_rel(jback.predict_mean_std(jnp.asarray(xt))[0],
                        jfit_mean))
    bound = chip_smoke.FORGET_FP32_BOUND
    assert max(port) <= bound and max(ref) <= bound, (port, ref)
    assert max(port) <= PORT_OVER_JAX * max(ref), (port, ref)
    assert min(port) > 0.0       # fp32 moments: not exact, as C5 says
