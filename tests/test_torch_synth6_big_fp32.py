"""synth6_big at full size with fp32 moments, both packages on the CPU.

`chip_smoke.py` holds the port's fp32-moment Nystrom arm on the card
(synth6_big, 89,000 rows fit + 1,000 extended, m = 2048, rank_rtol 1e-8,
chunk_norm, predict the 30,000 test rows) to a q-error that the JAX package
scored on another chip. fp32 moments pass through a whitening that amplifies
rounding by up to 1e4, so two correct implementations on two machines differ
in the third digit of the p95. This test tells that rounding from a fault of
the port: the same rows, inducing rows and protocol go through
`nngp_tpu.gp.fit_nystrom` and `nngp_tpu_torch.gp.fit_nystrom` on one
machine, and the two must agree with each other far closer than either
agrees with the other chip's number. It prints both q-errors: the JAX CPU
value is what `chip_smoke.py`'s `NY_ANCHORS['fp32']` is pinned to.

Minutes of CPU, so it is marked slow and is no part of the fast gate.
"""

import numpy as np
import pytest

import nngp_tpu.gp.nystrom as JN
from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.gp.nystrom import select_inducing
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from tests.test_torch_common import jax_spec

M, EXT, CHUNK = 2048, 1000, 8192


def _q(mean, y):
    from nngp_tpu_torch.eval.qerror import symmetric_qerror

    q = symmetric_qerror(np.asarray(mean, np.float64).ravel() - y)
    return float(np.median(q)), float(np.quantile(q, 0.95))


@pytest.mark.slow
def test_fp32_moments_90k_port_matches_jax_on_one_machine(tmp_path):
    import chip_smoke

    train, test = chip_smoke.big_split(str(tmp_path))
    x_tr, y_tr = chip_smoke.encode_big(train)
    x_te, y_te = chip_smoke.encode_big(test)
    assert x_tr.shape == (90000, 61) and x_te.shape == (30000, 61)
    yv = y_te.ravel().astype(np.float64)
    rows = x_tr[select_inducing(x_tr.shape[0], M, 0)]
    spec = reference_kernel()
    kw = dict(num_inducing=M, inducing_rows=rows, input_scale=1.0,
              moments="fp32")

    post = fit_nystrom(spec, x_tr[:-EXT], y_tr[:-EXT], device="cpu", **kw)
    ext = post.extend(x_tr[-EXT:], y_tr[-EXT:])
    mean, _ = ext.predict_mean_std_chunked(x_te, chunk=CHUNK)
    port = _q(mean, yv)

    jpost = JN.fit_nystrom(jax_spec(spec), x_tr[:-EXT], y_tr[:-EXT], **kw)
    jext = jpost.extend(x_tr[-EXT:], y_tr[-EXT:])
    jmean, _ = jext.predict_mean_std_chunked(x_te, chunk=CHUNK)
    jax_q = _q(jmean, yv)

    print(f"\nsynth6_big 90k fp32 moments on the CPU: rank_rtol "
          f"{post.rank_rtol!r} / {float(jpost.rank_rtol)!r}, rank "
          f"{post.rank} / {int(jpost.rank)}; port median={port[0]!r} "
          f"p95={port[1]!r}; JAX median={jax_q[0]!r} p95={jax_q[1]!r}")
    assert post.rank_rtol == pytest.approx(1e-8)
    assert float(jpost.rank_rtol) == pytest.approx(1e-8)
    # one machine, two implementations: the rounding of two fp32 GEMM
    # libraries through the whitening, far inside the 2% / 3% that the card
    # is allowed against this value
    assert port[0] == pytest.approx(jax_q[0], rel=5e-3)
    assert port[1] == pytest.approx(jax_q[1], rel=1e-2)
