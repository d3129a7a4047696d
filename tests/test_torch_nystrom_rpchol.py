"""The port's RPCholesky inducing selection
(`nngp_tpu_torch.gp.nystrom.select_inducing_rpchol`, `fit_nystrom(
inducing='rpchol')`) against the JAX package's (`nngp_tpu.gp.nystrom`), in
fp64 on the CPU, on the clustered rows of `tests/test_nystrom.py`.

Both packages draw the pivots from the same numpy generator with
probabilities from their own fp64 residual diagonals, so the indices are
equal, not close. Tolerances: the trace error and, for nngp, the fit's
mean and std rel 1e-9 (the two packages sum the same products in another
order); ntk fits rel 1e-7, as in tests/test_torch_nystrom.py (every
inducing row meets itself at rho = 1, where each package rounds the
generic NTK dual's acos its own way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.nystrom as JN
from nngp_tpu_torch.convert import nystrom_from_numpy, nystrom_to_numpy
from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.gp import nystrom as TN
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from tests.test_nystrom import _skewed_data
from tests.test_torch_common import jax_spec, n
from tests.torch_parallel_cases import on_ranks

RTOL = {"nngp": 1e-9, "ntk": 1e-7}
SPEC = reference_kernel()


def _close(got, want, rtol):
    got, want = np.asarray(n(got), np.float64), np.asarray(n(want),
                                                           np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _both(x, m, **kw):
    """(JAX's indices, the port's) on the same rows and arguments."""
    want = JN.select_inducing_rpchol(jax_spec(SPEC), x, m, **kw)
    got = TN.select_inducing_rpchol(SPEC, x, m, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_indices_match_jax(get, block, seed):
    """All 244 rows as candidates, and a 100-row candidate subsample
    (max_candidates < n); m = 24 takes 3 rounds of 8 or one of 64, m = 60
    up to 8 rounds of 8."""
    x, _ = _skewed_data()
    for m, cand in ((24, 65536), (24, 100), (60, 65536)):
        want, got = _both(x, m, get=get, seed=seed, block=block,
                          max_candidates=cand)
        assert got.dtype == want.dtype and 0 < len(got) <= m
        np.testing.assert_array_equal(got, want)


def test_m_at_least_n_is_the_identity():
    x, _ = _skewed_data()
    for m in (244, 300):
        want, got = _both(x, m, seed=1)
        np.testing.assert_array_equal(got, np.arange(244))
        np.testing.assert_array_equal(got, want)


def _trace_err(x, idx):
    """The port's fp64 residual trace tr(K - K_nm K_mm^+ K_mn)."""
    xt = torch.as_tensor(x)
    k = SPEC.kernel_fn(xt, xt, "nngp")
    ii = torch.as_tensor(idx)
    kmm, knm = k[ii][:, ii], k[:, ii]
    lam, v = torch.linalg.eigh(0.5 * (kmm + kmm.mT))
    keep = lam > 1e-12 * max(float(lam[-1]), 0.0)
    psi = knm @ (v[:, keep] / torch.sqrt(lam[keep])[None, :])
    return float(torch.trace(k) - torch.sum(psi * psi))


def test_trace_error_matches_jax():
    from tests.test_nystrom import _nystrom_trace_err

    x, _ = _skewed_data()
    for seed in range(4):
        want, got = _both(x, 20, seed=seed, block=8)
        np.testing.assert_allclose(
            _trace_err(x, got), _nystrom_trace_err(jax_spec(SPEC), x, want),
            rtol=1e-9)


def test_rpchol_beats_uniform_on_skewed_data():
    """The counterpart of tests/test_nystrom.py's: on clustered rows with
    rare outliers, RPCholesky's trace error averaged over seeds is under
    half of uniform selection's."""
    x, _ = _skewed_data()
    uni = np.mean([_trace_err(x, TN.select_inducing(len(x), 20, seed=s))
                   for s in range(4)])
    rp = np.mean([_trace_err(x, TN.select_inducing_rpchol(
        SPEC, x, 20, seed=s, block=8, device="cpu")) for s in range(4)])
    assert rp < 0.5 * uni, (rp, uni)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fit_nystrom_rpchol_matches_jax(get, tmp_path):
    """fit_nystrom(inducing='rpchol') selects on the prescaled rows with
    the fit's spec, get and seed: the inducing rows, mean, std and evidence
    of JAX's fit, then of an extend; forget(extend) gives the fit back,
    a checkpoint round trip (the JAX layout through .npz) predicts the
    same bit for bit, and grow_inducing keeps the selected rows as its
    prefix."""
    x, y = _skewed_data(seed=5)
    xt, x_new = x[::7] + 0.01, x[1::9] - 0.02
    y_new = np.cos(x_new.sum(axis=1))[:, None]
    kw = dict(num_inducing=32, get=get, seed=3, inducing="rpchol")
    jpost = JN.fit_nystrom(jax_spec(SPEC), x, y, **kw)
    post = fit_nystrom(SPEC, x, y, device="cpu", **kw)
    assert post.input_scale == pytest.approx(jpost.input_scale, rel=1e-15)
    np.testing.assert_array_equal(n(post.x_m), np.asarray(jpost.x_m))
    rtol = RTOL[get]
    for got, want in zip(post.predict_mean_std(torch.as_tensor(xt)),
                         jpost.predict_mean_std(jnp.asarray(xt))):
        _close(got, want, rtol)
    assert post.log_evidence() == pytest.approx(jpost.log_evidence(),
                                                rel=rtol)

    ext = post.extend(x_new, y_new)
    jext = jpost.extend(jnp.asarray(x_new), jnp.asarray(y_new))
    for got, want in zip(ext.predict_mean_std(torch.as_tensor(xt)),
                         jext.predict_mean_std(jnp.asarray(xt))):
        _close(got, want, rtol)
    back = ext.forget(x_new, y_new)
    _close(back.predict_mean_std(torch.as_tensor(xt))[0],
           post.predict_mean_std(torch.as_tensor(xt))[0], 1e-9)

    arrs, meta = nystrom_to_numpy(ext)
    np.savez(tmp_path / "ny.npz", **arrs)
    with np.load(tmp_path / "ny.npz") as f:
        restored = nystrom_from_numpy(dict(f), meta, SPEC, get,
                                      ext.diag_reg, "cpu")
    np.testing.assert_array_equal(n(restored.x_m), n(ext.x_m))
    for got, want in zip(restored.predict_mean_std(torch.as_tensor(xt)),
                         ext.predict_mean_std(torch.as_tensor(xt))):
        np.testing.assert_array_equal(n(got), n(want))

    grown = post.grow_inducing(x_new[:4], x, y)
    np.testing.assert_allclose(n(grown.x_m[:post.num_inducing]),
                               n(post.x_m), rtol=1e-15)
    assert grown.num_inducing == post.num_inducing + 4


def test_two_gloo_ranks_select_the_same_rows():
    """fit_nystrom(inducing='rpchol', mesh=) over two gloo ranks: rank 0
    selects and broadcasts, so both ranks hold the rows the fit without a
    mesh selects, and predict as it does (1e-12: the moments summed over
    ranks in another order)."""
    x, y = _skewed_data(seed=2)
    rng = np.random.default_rng(3)
    pl = {"spec": SPEC, "x": x, "y": y, "m": 24, "get": "nngp", "seed": 4,
          "xt": x[::11] + 0.01, "x_new": x[:9] + 0.03,
          "y_new": rng.standard_normal((9, 1))}
    ranks = on_ranks(2, "rpchol", pl)
    want = fit_nystrom(SPEC, x, y, num_inducing=24, seed=4,
                       inducing="rpchol", device="cpu")
    ext = want.extend(pl["x_new"], pl["y_new"])
    for out in ranks:
        np.testing.assert_array_equal(out["x_m"], n(want.x_m))
        for key, post in (("mean_std", want), ("ext", ext)):
            for got, w in zip(out[key], post.predict_mean_std(pl["xt"])):
                _close(got, w, 1e-12)


def test_errors():
    x, y = _skewed_data()
    # precision='high' is ported: on fp64 rows it is 'highest' itself
    np.testing.assert_array_equal(
        TN.select_inducing_rpchol(SPEC, x, 8, precision="high",
                                  device="cpu"),
        TN.select_inducing_rpchol(SPEC, x, 8, device="cpu"))
    with pytest.raises(ValueError, match="precision"):
        TN.select_inducing_rpchol(SPEC, x, 8, precision="default",
                                  device="cpu")
    with pytest.raises(ValueError, match="device="):
        TN.select_inducing_rpchol(SPEC, x, 8)
    with pytest.raises(ValueError, match="no pivots"):
        TN.select_inducing_rpchol(SPEC, np.zeros((30, 6)), 8, device="cpu")
