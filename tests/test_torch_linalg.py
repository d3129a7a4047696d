"""The port's Cholesky append (`nngp_tpu_torch.ops.linalg`), posterior
extend and ridge selection (`nngp_tpu_torch.gp.posterior`) against the JAX
package's, fp64 on the CPU.

Both extends start from the same fitted state (the JAX posterior's arrays
handed to the port), so only the append itself is compared. JAX's extend
evaluates K22's diagonal with the generic dual, whose NTK entries carry
acos's noise at rho = 1 (2e-9 relative, measured on these rows; through
the Schur complement 4e-7 in the factor); the port's `gram_sym` writes the
exact diagonal recursion, as both fits do. The comparison therefore runs
JAX's extend with the exact diagonal written onto its self-Gram
(`jax_exact_self_gram`), the same pinning as `_FUSED_FIT_MIN_N` for the
fit (ROADMAP Queue C).

Tolerances: the append rtol 1e-10; extend predictions rtol 1e-10 on the
mean, 1e-9 on the std (a difference of squares); extend against a refit
with the same absolute ridge rtol 1e-9 (two factorization orders through a
condition number ~1e5); ridge-selection scores rtol 1e-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.posterior as JP
from nngp_tpu.ops.linalg import cholesky_append_rows as jax_append
from nngp_tpu_torch.convert import STATE_KEYS, posterior_from_numpy
from nngp_tpu_torch.gp import fit_gp, select_diag_reg
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp, \
    reference_kernel
from nngp_tpu_torch.ops.linalg import cholesky_append_rows
from tests.test_torch_common import jax_spec, n, rows, t


@pytest.fixture
def jax_exact_diag(monkeypatch):
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)


@pytest.fixture
def jax_exact_self_gram(monkeypatch):
    """JAX's extend with the exact diagonal recursion written onto
    kernel_eval(x_new, x_new); the jitted extend is retraced on both
    sides so no other test sees the patched program."""
    orig = JP.kernel_eval

    def kernel_eval(layers, x1, x2=None, get="nngp"):
        out = orig(layers, x1, x2, get)
        if x2 is not x1:
            return out
        i = jnp.arange(x1.shape[0])
        diag = JP.diag_eval(layers, x1, get)
        if isinstance(get, tuple):
            return tuple(k.at[i, i].set(d) for k, d in zip(out, diag))
        return out.at[i, i].set(diag)

    monkeypatch.setattr(JP, "kernel_eval", kernel_eval)
    JP.GPPosterior._extend_dense.clear_cache()
    yield
    JP.GPPosterior._extend_dense.clear_cache()


def _spd(size, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((size, size))
    return a @ a.T + size * np.eye(size)


@pytest.mark.parametrize("n_old,m", [(1, 1), (40, 7), (130, 64)])
def test_cholesky_append_rows_matches_jax(n_old, m):
    k = _spd(n_old + m, seed=n_old)
    l11 = np.linalg.cholesky(k[:n_old, :n_old])
    k21, k22 = k[n_old:, :n_old], k[n_old:, n_old:]
    got = cholesky_append_rows(t(l11), t(k21), t(k22))
    want = jax_append(jnp.asarray(l11), jnp.asarray(k21), jnp.asarray(k22))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-12)
    # it is the factor of the whole matrix
    np.testing.assert_allclose(n(got) @ n(got).T, k, rtol=1e-10)
    assert np.array_equal(np.triu(n(got), 1), np.zeros_like(k))


def test_cholesky_append_rows_rejects_mismatched_blocks():
    l11 = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not form an append"):
        cholesky_append_rows(l11, torch.zeros(2, 3, dtype=torch.float64),
                             torch.eye(2, dtype=torch.float64))


def _extend_data(seed, n_train=200, n_new=24, n_test=30):
    rng = np.random.default_rng(seed + 50)
    x = rows(n_train, seed=seed)
    x_new = rng.uniform(0.0, 1000.0, (n_new, 20))
    xt = rows(n_test, seed=seed + 1)
    xt[3] = x_new[-1]                 # a test row that is a new train row
    y = rng.uniform(0.0, 16.0, (n_train, 1))
    y_new = rng.uniform(0.0, 16.0, (n_new, 1))
    return x, y, x_new, y_new, xt


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_extend_matches_jax_extend(get, jax_exact_diag, jax_exact_self_gram):
    spec = reference_kernel()
    x, y, x_new, y_new, xt = _extend_data(seed=11)
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      get=get)
    state = {k: (None if getattr(jpost, k) is None
                 else np.asarray(getattr(jpost, k))) for k in STATE_KEYS}
    post = posterior_from_numpy(state, spec, get, "cpu")
    jext = jpost.extend(jnp.asarray(x_new), jnp.asarray(y_new))
    ext = post.extend(x_new, y_new)
    assert ext.num_train == jext.num_train == x.shape[0] + x_new.shape[0]
    assert float(ext.reg) == float(post.reg)       # the fit's ridge is kept
    np.testing.assert_allclose(n(ext.l), n(jext.l), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(n(ext.alpha), n(jext.alpha), rtol=1e-10,
                               atol=1e-12)
    if get == "ntk":
        np.testing.assert_allclose(n(ext.k_tt_nngp), n(jext.k_tt_nngp),
                                   rtol=1e-12)
    mean, std = ext.predict_mean_std(t(xt))
    jmean, jstd = jext.predict_mean_std(jnp.asarray(xt))
    np.testing.assert_allclose(n(mean), n(jmean), rtol=1e-10)
    np.testing.assert_allclose(n(std), n(jstd), rtol=1e-9)
    # the posterior it was called on is unchanged
    assert post.num_train == x.shape[0]


@pytest.mark.parametrize("get,spec", [
    ("nngp", reference_kernel()),
    ("ntk", reference_kernel()),
    ("nngp", KernelSpec(mlp(2, activation="erf", b_std=0.1))),
], ids=["nngp", "ntk", "erf2-nngp"])
def test_extend_equals_refit_with_the_same_absolute_ridge(get, spec):
    """Two extends in a row land on the model a refit on all rows gives
    when the refit keeps the fit's ridge (diag_reg_absolute_scale)."""
    x, y, x_new, y_new, xt = _extend_data(seed=21)
    post = fit_gp(spec, x, y, get=get, device="cpu")
    ext = post.extend(x_new[:10], y_new[:10]).extend(t(x_new[10:]),
                                                     t(y_new[10:, 0]))
    refit = fit_gp(spec, np.concatenate([x, x_new]),
                   np.concatenate([y, y_new]), diag_reg=float(post.reg),
                   diag_reg_absolute_scale=True, get=get, device="cpu")
    mean, std = ext.predict_mean_std(t(xt))
    rmean, rstd = refit.predict_mean_std(t(xt))
    np.testing.assert_allclose(n(mean), n(rmean), rtol=1e-9)
    np.testing.assert_allclose(n(std), n(rstd), rtol=1e-9)
    np.testing.assert_allclose(ext.log_marginal_likelihood(),
                               refit.log_marginal_likelihood(), rtol=1e-9)


def test_extend_scales_new_rows_like_the_fit():
    """With an input prescale the new rows are divided by it before the
    Grams, as the fit's rows were: the extended prescaled posterior equals
    the extended unscaled one (fp64, where the prescale is pure
    bookkeeping)."""
    spec = reference_kernel()
    x, y, x_new, y_new, xt = _extend_data(seed=31, n_train=60, n_new=8)
    p0 = fit_gp(spec, x, y, device="cpu").extend(x_new, y_new)
    p1 = fit_gp(spec, x, y, device="cpu", input_scale=1024.0).extend(
        x_new, y_new)
    np.testing.assert_array_equal(n(p1.x_train)[-8:], x_new / 1024.0)
    m0, s0 = p0.predict_mean_std(t(xt))
    m1, s1 = p1.predict_mean_std(t(xt))
    np.testing.assert_allclose(n(m1), n(m0), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(n(s1), n(s0), rtol=1e-9, atol=1e-11)


def test_extend_rejects_bad_shapes():
    x, y, x_new, y_new, _ = _extend_data(seed=41, n_train=30, n_new=4)
    post = fit_gp(reference_kernel(), x, y, device="cpu")
    with pytest.raises(ValueError, match="x_new must be"):
        post.extend(x_new[:, :5], y_new)
    with pytest.raises(ValueError, match="x_new must be"):
        post.extend(x_new[:0], y_new[:0])
    with pytest.raises(ValueError, match="y_new has shape"):
        post.extend(x_new, y_new[:2])


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_select_diag_reg_matches_jax(get, jax_exact_diag):
    spec = reference_kernel()
    rng = np.random.default_rng(61)
    x = rows(150, seed=61)
    y = rng.uniform(0.0, 16.0, (150, 1))
    cands = (1e-4, 1e-3, 1e-2, 1e-1)
    best, scores = select_diag_reg(spec, x, y, candidates=cands, get=get,
                                   device="cpu")
    jbest, jscores = JP.select_diag_reg(jax_spec(spec), jnp.asarray(x),
                                        jnp.asarray(y), candidates=cands,
                                        get=get)
    assert scores.keys() == jscores.keys()
    for r in cands:
        np.testing.assert_allclose(scores[r], jscores[r], rtol=1e-8)
    assert best.diag_reg == jbest.diag_reg
    assert best.diag_reg == max(scores, key=scores.get)
    assert best.log_marginal_likelihood() == pytest.approx(
        scores[best.diag_reg], rel=1e-12)


def test_select_diag_reg_skips_a_ridge_that_fails_to_factor():
    """A candidate whose Gram is not positive definite scores NaN (torch
    raises where the JAX factor comes out NaN) and is never selected."""
    spec = reference_kernel()
    x = np.ones((6, 20))                   # six identical rows: rank one
    y = np.arange(6.0)[:, None]
    best, scores = select_diag_reg(spec, x, y, candidates=(0.0, 1e-2),
                                   device="cpu")
    assert np.isnan(scores[0.0]) and np.isfinite(scores[1e-2])
    assert best.diag_reg == 1e-2
    with pytest.raises(ValueError, match="needs device="):
        select_diag_reg(spec, x, y)
