"""The GP baselines of the port (`models/gp_rbf.py`, `models/dkl.py`,
`models/ski.py`) against the JAX package's on the same seeded numpy inputs,
fp64 on the CPU, with the JAX initial parameters and JAX's own Hutchinson
probes carried across. Tolerances: 1e-9 relative on losses, gradients,
trained parameters and predictions of the dense models; 1e-7 on the SKI
surrogate's gradient (two CG solves at tol 1e-12 lie between); the SKI
posterior tracks the exact DKL posterior to 5e-3, the JAX test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.models import dkl as JD
from nngp_tpu.models import gp_rbf as JG
from nngp_tpu.models import ski as JS
from nngp_tpu_torch.convert import (flat_params_from_numpy,
                                    flat_params_to_numpy)
from nngp_tpu_torch.models import dkl as TD
from nngp_tpu_torch.models import gp_rbf as TG
from nngp_tpu_torch.models import ski as TS
from tests.test_torch_common import n, t

RTOL = 1e-9


def _data(rows, d, seed, test_rows=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1000.0, (rows, d))
    y = rng.standard_normal((rows, 1)) * 3.0 + 5.0
    xt = rng.uniform(0.0, 1000.0, (test_rows, d))
    return x, y, xt


def _np_tree(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


def _grads(loss, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    value = loss(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, map(n, grads)))


def _close_tree(got, want, rtol=RTOL, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------------ gp_rbf
def _rbf_data():
    # features in [0, 3): at the initial lengthscale softplus(0) the Gram is
    # far from the identity, so every gradient is live
    x, y, xt = _data(60, 6, 0, test_rows=15)
    return x / 1000.0 * 3.0, y, xt / 1000.0 * 3.0


def test_gp_rbf_loss_and_gradient_match_jax():
    x, y, _ = _rbf_data()
    jp = JG.init_params(jnp.float64)
    want = float(JG.neg_marginal_likelihood(jp, jnp.asarray(x),
                                            jnp.asarray(y)))
    jgrads = jax.grad(JG.neg_marginal_likelihood)(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    tp = TG.init_params(torch.float64)
    _close_tree(tp, _np_tree(jp), rtol=0)
    got, grads = _grads(lambda p: TG.neg_marginal_likelihood(p, t(x), t(y)),
                        tp)
    assert got == pytest.approx(want, rel=RTOL)
    _close_tree(grads, _np_tree(jgrads))
    assert all(np.abs(g).max() > 1e-3 for g in grads.values())


def test_gp_rbf_ten_train_steps_and_predict_match_jax():
    x, y, xt = _rbf_data()
    jlines, tlines = [], []
    jp = JG.train(jnp.asarray(x), jnp.asarray(y), verbose=jlines.append)
    tp = TG.train(t(x), t(y), verbose=tlines.append)
    _close_tree(tp, _np_tree(jp))
    assert len(tlines) == 10 and tlines == jlines
    jmu, jvar = JG.predict(jp, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(xt))
    mu, var = TG.predict(tp, t(x), t(y), t(xt))
    assert mu.shape == (15, 1) and var.shape == (15, 15)
    np.testing.assert_allclose(n(mu), n(jmu), rtol=RTOL)
    np.testing.assert_allclose(n(var), n(jvar), rtol=1e-7, atol=1e-10)


def test_gp_rbf_half_gradient_on_the_clamped_diagonal():
    """d(x, x) is 0 up to rounding: `torch.maximum` passes half the
    gradient there as `jnp.maximum` does, so the gradients agree also on
    rows whose self-distance rounds to exactly 0 (duplicated rows too)."""
    x = np.arange(12, dtype=np.float64).reshape(6, 2) / 8.0
    x[5] = x[4]
    y = np.linspace(-1.0, 1.0, 6).reshape(-1, 1)
    jgrads = jax.grad(JG.neg_marginal_likelihood)(
        JG.init_params(jnp.float64), jnp.asarray(x), jnp.asarray(y))
    _, grads = _grads(lambda p: TG.neg_marginal_likelihood(p, t(x), t(y)),
                      TG.init_params(torch.float64))
    _close_tree(grads, _np_tree(jgrads), rtol=1e-8, atol=1e-12)
    assert all(np.abs(g).max() > 1e-3 for g in grads.values())


def test_cholesky_failure_raises():
    with pytest.raises(RuntimeError, match="failed at leading minor 2"):
        TG.cholesky(torch.tensor([[1.0, 2.0], [2.0, 1.0]]), "test")


# --------------------------------------------------------------------- dkl
def _dkl_params(d, hid, seed):
    jp = JD.init_dkl_params(jax.random.PRNGKey(seed), d, hid)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jp)
    # move the constants off zero so that every leaf's gradient is generic
    rng = np.random.default_rng(seed)
    jp = {k: v + 0.1 * jnp.asarray(rng.standard_normal(v.shape))
          for k, v in jp.items()}
    return jp, flat_params_from_numpy(_np_tree(jp))


def _tied_rows(jp, x):
    """x with a zero row (every ReLU input exactly 0 at zero bias) and the
    rows that attain column 0's min and column 1's max duplicated, so that
    the rescale's min and max are each attained twice."""
    z = np.asarray(JD._embed(jp, jnp.asarray(x)))
    return np.concatenate([x, x[[np.argmin(z[:, 0]), np.argmax(z[:, 1])]],
                           np.zeros((1, x.shape[1]))])


@pytest.mark.parametrize("tied", [False, True], ids=["generic", "tied"])
def test_dkl_neg_mll_value_and_every_gradient_leaf_match_jax(tied):
    x, y, _ = _data(50, 7, 1)
    jp, tp = _dkl_params(7, 12, 2)
    if tied:
        jp = dict(jp, b1=jnp.zeros_like(jp["b1"]))
        tp = dict(tp, b1=torch.zeros_like(tp["b1"]))
        x = _tied_rows(jp, x)
        y = np.concatenate([y, y[:3] + 0.5])
        z = np.asarray(JD._embed(jp, jnp.asarray(x)))
        assert (z[:, 0] == z[:, 0].min()).sum() >= 2
        assert (z[:, 1] == z[:, 1].max()).sum() >= 2
    want, jgrads = jax.value_and_grad(JD.neg_mll)(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    got, grads = _grads(lambda p: TD.neg_mll(p, t(x), t(y)), tp)
    assert got == pytest.approx(float(want), rel=RTOL)
    _close_tree(grads, _np_tree(jgrads), rtol=1e-8, atol=1e-10)


def test_dkl_three_adam_epochs_match_jax():
    x, y, _ = _data(40, 5, 3)
    jp0 = JD.init_dkl_params(jax.random.PRNGKey(0), 5, 16)
    lines, jlines = [], []
    # JAX's trainer draws the same init from PRNGKey(seed) itself (fp64
    # under x64); it rounds its data to fp32, so the port is given the same
    # rounded data
    jp = JD.train_dkl(x, y, hid_dim=16, epochs=3, seed=0,
                      verbose=jlines.append)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    tp = TD.train_dkl(x32, y32, hid_dim=16, epochs=3, device="cpu",
                      init=flat_params_from_numpy(_np_tree(jp0)),
                      verbose=lines.append)
    _close_tree(tp, _np_tree(jp), rtol=1e-7, atol=1e-9)
    assert lines == jlines


def test_predict_dkl_matches_jax_and_holds_under_a_shifted_test_batch():
    x, y, xt = _data(45, 6, 4, test_rows=12)
    jp, tp = _dkl_params(6, 10, 5)
    jm, js = JD.predict_dkl(jp, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(xt))
    m, s = TD.predict_dkl(tp, x, y, xt)
    np.testing.assert_allclose(n(m), n(jm), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(n(s), n(js), rtol=1e-7, atol=1e-9)
    # joint normalization: a test point equal to a training point gets the
    # same embedding even when the test batch spans a different range
    rng = np.random.default_rng(0)
    x_tr = rng.uniform(-1, 1, (30, 4)).astype(np.float32)
    y_tr = x_tr.sum(axis=1, keepdims=True).astype(np.float32)
    params = TD.train_dkl(x_tr, y_tr, epochs=3, device="cpu")
    x_te = np.vstack([x_tr[:1], x_tr[:1] + 1e-3]).astype(np.float32)
    mean, std = TD.predict_dkl(params, x_tr, y_tr, x_te)
    assert mean.dtype == torch.float32 and std.shape == (2,)
    assert abs(float(mean[0]) - float(y_tr[0, 0])) < 0.5


def test_init_dkl_params_follow_the_jax_law():
    p = TD.init_dkl_params(torch.Generator().manual_seed(0), 50, 256)
    again = TD.init_dkl_params(torch.Generator().manual_seed(0), 50, 256)
    jp = JD.init_dkl_params(jax.random.PRNGKey(0), 50, 256)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("b1", "b2", "raw_lengthscale", "raw_amp", "raw_noise",
              "mean_const"):
        np.testing.assert_array_equal(n(p[k]), np.asarray(jp[k]))
    for k, fan_in in (("w1", 50), ("w2", 256)):
        bound = 1.0 / np.sqrt(fan_in)
        w = n(p[k])
        assert np.abs(w).max() <= bound and np.array_equal(w, n(again[k]))
        # uniform on +-bound: std bound / sqrt(3)
        assert w.std() == pytest.approx(bound / np.sqrt(3), rel=0.1)


# --------------------------------------------------------------------- ski
def test_interpolation_matrix_and_products_match_jax():
    rng = np.random.default_rng(6)
    z = rng.uniform(-1.0, 1.0, (40, 3))
    z[0] = -1.0
    z[1] = 1.0
    v = rng.standard_normal((40, 5))
    for g in (16, 48):
        np.testing.assert_allclose(
            n(TS.cubic_interp_matrix(t(z[:, 0]), g)),
            n(JS.cubic_interp_matrix(jnp.asarray(z[:, 0]), g)),
            rtol=1e-12, atol=1e-14)
    for dims in (1, 2, 3):
        jws = JS.interp_weights(jnp.asarray(z[:, :dims]), 12)
        tws = TS.interp_weights(t(z[:, :dims]), 12)
        ju = JS.interp_t_apply(jws, jnp.asarray(v))
        tu = TS.interp_t_apply(tws, t(v))
        assert tu.shape == (12,) * dims + (5,)
        np.testing.assert_allclose(n(tu), n(ju), rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(n(TS.interp_apply(tws, tu)),
                                   n(JS.interp_apply(jws, ju)),
                                   rtol=1e-11, atol=1e-13)
        ls = np.linspace(0.3, 0.9, dims)
        jk = [JS._kuu_1d(JS.grid_points(12, dtype=jnp.float64), l)
              for l in ls]
        tk = [TS._kuu_1d(TS.grid_points(12, dtype=torch.float64), l)
              for l in ls]
        np.testing.assert_allclose(
            n(TS.ski_mvm(tws, tk, 0.7, 0.2, t(v))),
            n(JS.ski_mvm(jws, jk, 0.7, 0.2, jnp.asarray(v))),
            rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(n(TS.ski_diag(tws, tk, 0.7)),
                                   n(JS.ski_diag(jws, jk, 0.7)),
                                   rtol=1e-10)
        # against the materialized operator
        dense = n(TS.ski_mvm(tws, tk, 0.7, 0.2,
                             torch.eye(40, dtype=torch.float64)))
        np.testing.assert_allclose(np.diag(dense) - 0.2,
                                   n(TS.ski_diag(tws, tk, 0.7)), rtol=1e-10)
        np.testing.assert_allclose(dense, dense.T, atol=1e-12)


def _jax_probes(key, rows, num):
    return np.where(np.asarray(jax.random.bernoulli(key, 0.5, (rows, num))),
                    1.0, -1.0)


def test_neg_mll_ski_value_and_gradient_match_jax_with_jax_probes():
    x, y, _ = _data(60, 5, 7)
    jp, tp = _dkl_params(5, 16, 8)
    key = jax.random.PRNGKey(8)
    kw = dict(grid_size=48, cg_tol=1e-12, cg_iters=400)
    want, jgrads = jax.value_and_grad(JS.neg_mll_ski)(
        jp, jnp.asarray(x), jnp.asarray(y), key, **kw)
    probes = t(_jax_probes(key, 60, 8))
    got, grads = _grads(
        lambda p: TS.neg_mll_ski(p, t(x), t(y), probes=probes, **kw), tp)
    assert got == pytest.approx(float(want), rel=1e-8)
    _close_tree(grads, _np_tree(jgrads), rtol=1e-7, atol=1e-9)
    # the value is the SLQ estimate, its gradient the surrogate's: the
    # mean_const gradient is the closed form -sum(K^-1 (y - c))
    z = TD._rescale(TD._embed(tp, t(x)))
    ws, kuu, amp, noise = TS._ski_parts(tp, z, 48)
    k = TS.ski_mvm(ws, kuu, amp, noise, torch.eye(60, dtype=torch.float64))
    alpha = torch.linalg.solve(k, t(y) - tp["mean_const"])
    assert grads["mean_const"] == pytest.approx(-float(alpha.sum()),
                                                rel=1e-7)
    # from a generator: the same seed gives the same loss, another another
    def from_seed(seed):
        gen = torch.Generator().manual_seed(seed)
        return float(TS.neg_mll_ski(tp, t(x), t(y), gen, **kw))

    assert from_seed(1) == from_seed(1) != from_seed(2)
    assert from_seed(1) == pytest.approx(got, rel=0.05)
    with pytest.raises(ValueError, match="generator or the probes"):
        TS.neg_mll_ski(tp, t(x), t(y))


def test_predict_dkl_ski_matches_jax_and_tracks_exact_dkl():
    rng = np.random.default_rng(4)
    x_tr = rng.uniform(0, 1000, (150, 8))
    y_tr = rng.standard_normal((150, 1))
    x_te = rng.uniform(0, 1000, (40, 8))
    jp = JD.init_dkl_params(jax.random.PRNGKey(5), 8, 32)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jp)
    tp = flat_params_from_numpy(_np_tree(jp))
    kw = dict(cg_tol=1e-12, cg_iters=500)
    jm, js = JS.predict_dkl_ski(jp, jnp.asarray(x_tr), jnp.asarray(y_tr),
                                jnp.asarray(x_te), **kw)
    m_ski, s_ski = TS.predict_dkl_ski(tp, x_tr, y_tr, x_te, var_chunk=16,
                                      **kw)
    np.testing.assert_allclose(n(m_ski), n(jm), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(n(s_ski), n(js), rtol=1e-6, atol=1e-8)
    m_exact, s_exact = TD.predict_dkl(tp, x_tr, y_tr, x_te)
    np.testing.assert_allclose(n(m_ski), n(m_exact), atol=5e-3)
    np.testing.assert_allclose(n(s_ski), n(s_exact), atol=5e-3)


def test_train_dkl_ski_runs_and_round_trips_its_parameters():
    x, y, xt = _data(64, 6, 9, test_rows=10)
    lines = []
    params = TS.train_dkl_ski(x, y, hid_dim=16, epochs=3, grid_size=32,
                              device="cpu", verbose=lines.append)
    assert len(lines) == 3 and lines[0].startswith("0-th Epochs: SKI-DKL")
    again = TS.train_dkl_ski(x, y, hid_dim=16, epochs=3, grid_size=32,
                             device="cpu")
    _close_tree(again, flat_params_to_numpy(params), rtol=0)
    start = TD.init_dkl_params(torch.Generator().manual_seed(0), 6, 16)
    assert any(not torch.equal(params[k], start[k]) for k in params)
    mean, std = TS.predict_dkl_ski(params, x, y, xt, grid_size=32)
    assert mean.shape == (10,) and bool(torch.isfinite(mean).all())
    assert bool((std >= 0).all())
