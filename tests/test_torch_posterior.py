"""The port's exact GP posterior (`nngp_tpu_torch.gp.posterior`) against the
JAX package's, fp64 on the CPU.

The JAX fits run with `_FUSED_FIT_MIN_N` lowered so they take the path the
forest workload takes at 10.8k rows, which writes the exact O(n) diagonal
into the solve Gram, as the port always does. JAX's small-n path adds the
ridge to the computed diagonal instead, whose NTK entries carry acos's
sqrt(eps) noise at rho = 1; through a solve with condition number ~1e5
that alone would move the mean by more than the tolerances below.

Tolerances: rtol 1e-7 on the mean, 1e-6 on the std and the covariance.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.posterior as JP
from nngp_tpu_torch.convert import (STATE_KEYS, posterior_from_numpy,
                                    posterior_to_numpy)
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp.posterior import (_auto_input_scale,
                                         input_scale_for_bound)
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp, \
    reference_kernel
from tests.test_torch_common import jax_spec, n, rows, t


@pytest.fixture
def jax_exact_diag(monkeypatch):
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)


def _data(n_train=300, n_test=40, scale=1000.0, dtype=np.float64, seed=0,
          shared_row=True):
    rng = np.random.default_rng(seed + 100)
    x = rows(n_train, seed=seed, scale=scale, dtype=dtype)
    xt = rows(n_test, seed=seed + 1, scale=scale, dtype=dtype)
    if shared_row:
        xt[7] = x[11]   # a test row that is also a train row
    y = rng.uniform(0.0, 16.0, (n_train, 1)).astype(dtype)
    return x, y, xt


def _cov_close(got, want):
    want = n(want)
    np.testing.assert_allclose(n(got), want, rtol=1e-6,
                               atol=1e-6 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fit_and_predict_match_jax(get, jax_exact_diag):
    spec = reference_kernel()
    x, y, xt = _data()
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      get=get)
    post = fit_gp(spec, x, y, get=get, device="cpu")
    assert post.input_scale == jpost.input_scale == 1.0
    np.testing.assert_allclose(float(post.reg), float(jpost.reg), rtol=1e-12)
    assert (post.k_tt_nngp is None) == (jpost.k_tt_nngp is None)

    mean = post.predict(t(xt), compute_cov=False)
    np.testing.assert_allclose(
        n(mean), n(jpost.predict(jnp.asarray(xt), compute_cov=False)),
        rtol=1e-7)
    m_d, v_d = post.predict(t(xt), compute_cov="diag")
    jm_d, jv_d = jpost.predict(jnp.asarray(xt), compute_cov="diag")
    np.testing.assert_allclose(n(m_d), n(jm_d), rtol=1e-7)
    _cov_close(v_d, jv_d)
    m_f, cov = post.predict(xt, compute_cov=True)     # numpy input
    jm_f, jcov = jpost.predict(jnp.asarray(xt), compute_cov=True)
    np.testing.assert_allclose(n(m_f), n(jm_f), rtol=1e-7)
    _cov_close(cov, jcov)
    np.testing.assert_allclose(np.diag(n(cov)), n(v_d), rtol=1e-6,
                               atol=1e-6 * float(np.max(n(v_d))))

    mean, std = post.predict_mean_std(t(xt))
    jmean, jstd = jpost.predict_mean_std(jnp.asarray(xt))
    np.testing.assert_allclose(n(mean), n(jmean), rtol=1e-7)
    np.testing.assert_allclose(n(std), n(jstd), rtol=1e-6,
                               atol=1e-6 * float(np.max(n(jstd))))
    np.testing.assert_allclose(post.log_marginal_likelihood(),
                               jpost.log_marginal_likelihood(), rtol=1e-9)

    cm, cs = post.predict_mean_std_chunked(xt, chunk=16)
    jcm, jcs = jpost.predict_mean_std_chunked(xt, chunk=16)
    np.testing.assert_allclose(cm, jcm, rtol=1e-7)
    np.testing.assert_allclose(cs, jcs, rtol=1e-6, atol=1e-6 * np.max(jcs))


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_absolute_ridge_and_deeper_spec_match_jax(get, jax_exact_diag):
    spec = KernelSpec(mlp(2, activation="erf", b_std=0.1))
    x, y, xt = _data(n_train=200, seed=3)
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      diag_reg=0.05, get=get, diag_reg_absolute_scale=True)
    post = fit_gp(spec, t(x), t(y), diag_reg=0.05, get=get,
                  diag_reg_absolute_scale=True)
    assert float(post.reg) == 0.05 and post.device == torch.device("cpu")
    mean, std = post.predict_mean_std(t(xt))
    jmean, jstd = jpost.predict_mean_std(jnp.asarray(xt))
    np.testing.assert_allclose(n(mean), n(jmean), rtol=1e-7)
    np.testing.assert_allclose(n(std), n(jstd), rtol=1e-6,
                               atol=1e-6 * float(np.max(n(jstd))))


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_posterior_from_numpy_predicts_what_jax_predicts(get, jax_exact_diag):
    spec = reference_kernel()
    x, y, xt = _data(seed=5)
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      get=get)
    state = {k: (None if getattr(jpost, k) is None
                 else np.asarray(getattr(jpost, k))) for k in STATE_KEYS}
    post = posterior_from_numpy(state, spec, get, "cpu")
    mean, std = post.predict_mean_std(t(xt))
    jmean, jstd = jpost.predict_mean_std(jnp.asarray(xt))
    # the same factor and alpha: only the cross Gram and the solves differ
    np.testing.assert_allclose(n(mean), n(jmean), rtol=1e-9)
    np.testing.assert_allclose(n(std), n(jstd), rtol=1e-7,
                               atol=1e-9 * float(np.max(n(jstd))))
    _, cov = post.predict(t(xt), compute_cov=True)
    _cov_close(cov, jpost.predict(jnp.asarray(xt), compute_cov=True)[1])
    back = posterior_to_numpy(post)
    assert set(back) == set(STATE_KEYS)
    for key in STATE_KEYS:
        if state[key] is None:
            assert back[key] is None
        else:
            np.testing.assert_array_equal(np.asarray(back[key]).ravel(),
                                          np.asarray(state[key]).ravel())


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_prescale_compensation_is_exact_fp64(get, jax_exact_diag):
    """test_prescale.py's semantics: a power-of-two input_scale changes
    nothing but rounding in fp64 (mean, std, full covariance, evidence),
    and the scaled port agrees with the scaled JAX posterior."""
    spec = reference_kernel()
    x, y, xt = _data(n_train=60, n_test=16, seed=7)
    p0 = fit_gp(spec, x, y, get=get, device="cpu")
    p1 = fit_gp(spec, x, y, get=get, device="cpu", input_scale=1024.0)
    assert p1.input_scale == 1024.0
    np.testing.assert_array_equal(n(p1.x_train), x / 1024.0)
    m0, s0 = p0.predict_mean_std(t(xt))
    m1, s1 = p1.predict_mean_std(t(xt))
    np.testing.assert_allclose(n(m1), n(m0), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(n(s1), n(s0), rtol=1e-9, atol=1e-11)
    _, c0 = p0.predict(t(xt), compute_cov=True)
    _, c1 = p1.predict(t(xt), compute_cov=True)
    np.testing.assert_allclose(n(c1), n(c0), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(p1.log_marginal_likelihood(),
                               p0.log_marginal_likelihood(), rtol=1e-9)
    jp1 = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                    get=get, input_scale=1024.0)
    jm1, js1 = jp1.predict_mean_std(jnp.asarray(xt))
    np.testing.assert_allclose(n(m1), n(jm1), rtol=1e-7)
    np.testing.assert_allclose(n(s1), n(js1), rtol=1e-6,
                               atol=1e-6 * float(np.max(n(js1))))


def test_auto_input_scale_rules_match_jax():
    spec = reference_kernel()
    layers, jlayers = spec.layers, jax_spec(spec).layers
    cases = [
        rows(8, scale=2.0 ** 60),                            # fp64: never
        rows(8, scale=1000.0, dtype=np.float32),             # forest scale
        rows(8, scale=2.0 ** 30, dtype=np.float32),          # prescale
        rows(8, scale=2.0 ** 40, dtype=np.float32),
    ]
    for x in cases:
        want = JP._auto_input_scale(x, jlayers)
        assert _auto_input_scale(x, layers) == want
        assert _auto_input_scale(t(x), layers) == want
    assert _auto_input_scale(cases[2], layers) == 2.0 ** 30
    for other in (KernelSpec(mlp(1, activation="erf")),
                  KernelSpec(mlp(1, b_std=0.5))):
        assert _auto_input_scale(cases[3], other.layers) == 1.0
    for bound in (0.0, 1000.0, 2.0 ** 20, 2.0 ** 20 + 1, 2.0 ** 64,
                  math.inf):
        assert input_scale_for_bound(bound, layers) == \
            JP.input_scale_for_bound(bound, jlayers)
    assert input_scale_for_bound(2.0 ** 64, layers, fp64=True) == 1.0


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fp32_2p30_features_prescale_and_track_fp64(get):
    """2^30-scale fp32 features with the bias-free relu spec: the fit picks
    the covering power of two, as the JAX package does, stays finite, and
    tracks the raw-feature fp64 fit (test_prescale.py's fp32 bounds: mean
    atol 0.05, std rtol 0.05)."""
    spec = reference_kernel()
    # no test row repeats a train row: its std is a cancellation that
    # fp32 resolves only to ~10% (test_prescale.py has none either)
    x, y, xt = _data(n_train=60, n_test=16, scale=2.0 ** 30, seed=9,
                     shared_row=False)
    p64 = fit_gp(spec, x, y, get=get, device="cpu")
    m64, s64 = p64.predict_mean_std(t(xt))
    x32, y32, xt32 = (a.astype(np.float32) for a in (x, y, xt))
    p32 = fit_gp(spec, x32, y32, get=get, device="cpu")
    assert p32.input_scale == 2.0 ** 30 == JP._auto_input_scale(
        x32, jax_spec(spec).layers)
    m32, s32 = p32.predict_mean_std(t(xt32))
    assert np.all(np.isfinite(n(m32))) and np.all(np.isfinite(n(s32)))
    np.testing.assert_allclose(n(m32).ravel(), n(m64).ravel(), rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(n(s32), n(s64), rtol=0.05)


def test_fit_gp_rejects_bad_arguments():
    spec = reference_kernel()
    x, y, xt = _data(n_train=20, n_test=8)
    with pytest.raises(ValueError, match="get must be"):
        fit_gp(spec, x, y, get="gp", device="cpu")
    with pytest.raises(ValueError, match="needs device="):
        fit_gp(spec, x, y)
    with pytest.raises(TypeError, match="float32 or float64"):
        fit_gp(spec, x.astype(np.int64), y, device="cpu")
    post = fit_gp(spec, x, y, device="cpu")
    with pytest.raises(ValueError, match="compute_cov"):
        post.predict(t(xt), compute_cov="full")
    with pytest.raises(ValueError, match="chunk"):
        post.predict_mean_std_chunked(xt, chunk=0)
