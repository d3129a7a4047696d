"""The port's hyperparameter learning (`nngp_tpu_torch.gp.hyperopt`)
against the JAX package's, fp64 on the CPU.

Tolerances: losses rtol 1e-10; gradients rtol 1e-8 of each leaf's largest
entry; grad-safe dual values rtol 1e-12 and their gradients rtol 1e-8,
each of the largest entry (the JAX acos is a rational approximation,
torch's is libm's, and near rho = -1 the relu dual is a cancellation of
terms 1e9 times its size); after a
multi-restart learn of at most 20 steps the learned w0, w, b, ridge and
ARD scale rtol 1e-6, the log evidence 1e-6 absolute, and the winning
restart's whole loss history rtol 1e-8 (which pins the winning restart:
the restarts start at different ridges). The JAX compiles are a handful
of configurations shared through module fixtures.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nngp_tpu.gp.hyperopt as JH
import nngp_tpu.gp.posterior as JP
import nngp_tpu_torch.gp.hyperopt as H
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.models.kernel_spec import KernelSpec
from tests.test_torch_common import jax_spec, n, rows, t

THETA = {"log_w0": np.log(0.7), "log_w": np.log(1.3), "log_b": np.log(0.4),
         "log_reg": np.log(2e-3)}


def _data(n_rows=48, seed=0):
    """Forest-scale rows with a zero row and an exact duplicated pair, and
    labels that depend on three features."""
    x = rows(n_rows, seed=seed)
    rng = np.random.default_rng(seed + 100)
    y = x[:, :3].sum(1, keepdims=True) / 300.0 + rng.normal(0, 0.3,
                                                            (n_rows, 1))
    return x, y


def _close_tree(got, want, rtol):
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w))),
                                   err_msg=k)


# ------------------------------------------------------- grad-safe duals
def _dual_inputs():
    """(k12, k11, k22) with rho on a grid that reaches +-(1 - 1e-6) inside
    the clamp, +-(1 - 1e-13) beyond it (eps = 1e-12), and exactly +-1 (a
    duplicated row), never on the clamp boundary itself. Nearer to +-1
    inside the clamp, the relu dual's derivative is a difference of terms
    of size 1/sqrt(1 - rho^2) in both packages, whose roundings differ:
    at 1 - 1e-9 by ~1e-6 of the result."""
    rho = np.array([-1.0, -(1 - 1e-13), -(1 - 1e-6), -0.7, -0.1, 0.0, 0.3,
                    0.9, 1 - 1e-4, 1 - 1e-6, 1 - 1e-13, 1.0])
    k11 = np.linspace(0.5, 40.0, rho.size)
    k22 = np.linspace(30.0, 2.0, rho.size)
    return rho * np.sqrt(k11 * k22), k11, k22


@pytest.mark.parametrize("act", ["relu", "erf", "abs", "sin"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["nngp", "ntk", "diag"])
def test_grad_safe_duals_match_jax(act, which):
    eps = 1e-12
    fn = H._grad_safe_duals(eps)[act][which]
    jfn = JH._grad_safe_duals(eps)[act][which]
    args = _dual_inputs()
    if which == 2:
        args = (np.linspace(0.1, 50.0, 12),)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    val = fn(*targs)
    grads = torch.autograd.grad(val.sum(), targs)
    jval, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a)), argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    want = np.asarray(jfn(*args))
    np.testing.assert_allclose(n(val).sum(), float(jval), rtol=1e-12)
    np.testing.assert_allclose(n(val), want, rtol=1e-12,
                               atol=1e-12 * float(np.max(np.abs(want))))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(n(g), np.asarray(jg), rtol=1e-8,
                                   atol=1e-8 * float(np.max(np.abs(jg))))
        assert np.all(np.isfinite(n(g)))


# ---------------------------------------------------------------- losses
def _jax_loss(kind, get, act, depth, x, y, m=16):
    """The JAX loss and its gradient, jitted."""
    duals = JH._grad_safe_duals(1e-12)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if kind == "exact":
        k0, d1 = JH.input_gram(jx, jx), JH.input_diag(jx)

        def loss(th):
            return JH._nll(th, k0, d1, jy, depth, act, 512, get, duals)
    elif kind == "ard":
        def loss(th):
            return JH._nll_ard(th, jx, jy, depth, act, 512, get, duals)
    else:
        def loss(th):
            return JH._nll_dtc(th, jx, jy, m, depth, act, 512, get, duals)
    return jax.jit(jax.value_and_grad(loss))


def _port_loss(kind, get, act, depth, x, y, m=16):
    duals = H._grad_safe_duals(1e-12)
    tx, ty = t(x), t(y)
    if kind == "exact":
        k0, d1 = H.input_gram(tx, tx), H.input_diag(tx)
        return lambda th: H._nll(th, k0, d1, ty, depth, act, 512, get, duals)
    if kind == "ard":
        return lambda th: H._nll_ard(th, tx, ty, depth, act, 512, get, duals)
    return lambda th: H._nll_dtc(th, tx, ty, m, depth, act, 512, get, duals)


def _theta(kind, d):
    th = dict(THETA)
    if kind in ("ard", "dtc-ard"):
        del th["log_w0"]
        th["log_s"] = np.log(np.linspace(0.3, 1.7, d))
    return th


@pytest.mark.parametrize("kind,get,act,depth", [
    ("exact", "nngp", "relu", 1),
    ("exact", "ntk", "erf", 2),
    ("ard", "nngp", "relu", 2),
    ("ard", "ntk", "relu", 1),
    ("dtc", "nngp", "relu", 1),
    ("dtc-ard", "ntk", "erf", 1),
])
def test_losses_and_gradients_match_jax(kind, get, act, depth):
    """`_nll`, `_nll_ard` and `_nll_dtc` and their gradients. The port
    evaluates two restarts at once; each equals the JAX loss at its own
    theta."""
    x, y = _data()
    base = kind.split("-")[0]
    if base == "dtc":
        # keep the duplicated pair out of the 16 inducing rows: it would
        # make K_mm singular up to its 1e-10 jitter
        x, y = np.roll(x, -20, axis=0), np.roll(y, -20, axis=0)
    th = _theta(kind, x.shape[1])
    jloss = _jax_loss(base, get, act, depth, x, y)
    loss = _port_loss(base, get, act, depth, x, y)
    shifted = {k: v + 0.05 for k, v in th.items()}
    tth = {k: torch.tensor(np.stack([th[k], shifted[k]]), requires_grad=True)
           for k in th}
    val = loss(tth)
    grads = dict(zip(tth, torch.autograd.grad(val.sum(),
                                              list(tth.values()))))
    for r, point in enumerate((th, shifted)):
        jval, jgrad = jloss({k: jnp.asarray(v) for k, v in point.items()})
        np.testing.assert_allclose(float(val[r].detach()), float(jval),
                                   rtol=1e-10)
        _close_tree({k: n(g[r]) for k, g in grads.items()}, jgrad, 1e-8)


@pytest.mark.parametrize("kind", ["dtc", "dtc-ard"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_batched_dtc_loss_equals_each_restart_alone(kind, dtype):
    """The DTC loss of three restarts at once (the ridges 1e-3, 3e-2 and
    0.3 of `fit_kernel_hyperparams`) and its gradient equal each restart's
    own R = 1 loss and gradient: rel 1e-5 in fp32 (the batch may take other
    summation orders than R = 1), 1e-12 in fp64; and, in fp64, JAX's
    `_nll_dtc` at each restart's theta (rtol 1e-10, gradients 1e-8)."""
    x, y = _data()
    x, y = np.roll(x, -20, axis=0), np.roll(y, -20, axis=0)
    x, y = x.astype(dtype) / 1000.0, y.astype(dtype)
    th = _theta(kind, x.shape[1])
    pts = [dict(th, log_reg=np.log(r)) for r in (1e-3, 3e-2, 0.3)]
    pts = [{k: v + 0.03 * i for k, v in p.items()} for i, p in enumerate(pts)]
    loss = _port_loss("dtc", "nngp", "relu", 1, x, y)
    rtol = 1e-5 if dtype == np.float32 else 1e-12

    def value_grad(points):
        tth = {k: torch.tensor(np.stack([p[k] for p in points]).astype(
            dtype), requires_grad=True) for k in th}
        val = loss(tth)
        return val, dict(zip(tth, torch.autograd.grad(val.sum(),
                                                      list(tth.values()))))

    val, grads = value_grad(pts)
    assert bool(torch.all(torch.isfinite(val)))
    for r, point in enumerate(pts):
        one, one_g = value_grad([point])
        np.testing.assert_allclose(float(val[r].detach()),
                                   float(one[0].detach()), rtol=rtol)
        _close_tree({k: n(g[r]) for k, g in grads.items()},
                    {k: n(g[0]) for k, g in one_g.items()}, rtol)
    if dtype == np.float64:
        jloss = _jax_loss("dtc", "nngp", "relu", 1, x, y)
        for r, point in enumerate(pts):
            jval, jgrad = jloss({k: jnp.asarray(v) for k, v in point.items()})
            np.testing.assert_allclose(float(val[r].detach()), float(jval),
                                       rtol=1e-10)
            _close_tree({k: n(g[r]) for k, g in grads.items()}, jgrad, 1e-8)


def test_loss_at_pinned_values_equals_log_marginal_likelihood():
    """With the hyperparameters pinned, -loss is the fitted posterior's
    exact log evidence, nngp and ntk, on rows without a duplicated pair
    (where the clamp moves the NTK multiplier by sqrt(2 eps) / (2 pi),
    ~2e-7)."""
    x = rows(48, seed=1, special=False)
    y = _data()[1]
    w0, w, b, reg = 0.7, 1.3, 0.4, 2e-3
    for get in ("nngp", "ntk"):
        loss = _port_loss("exact", get, "relu", 2, x, y)
        val = loss({k: torch.tensor([v]) for k, v in THETA.items()})
        spec = KernelSpec(H._build_layers(2, "relu", 512, w0, w, b))
        post = fit_gp(spec, t(x), t(y), diag_reg=reg, get=get,
                      input_scale=1.0)
        np.testing.assert_allclose(-float(val[0]),
                                   post.log_marginal_likelihood(),
                                   rtol=1e-10)


def test_a_failed_factor_rejects_that_restart_only(monkeypatch):
    """Where `jnp.linalg.cholesky` returns NaN, `cholesky_ex` reports the
    failure in `info`. A factor made to fail for the second of two
    identical restarts, with finite garbage in its place (whose backward
    is finite too): that restart's loss is NaN, its steps are rejected,
    and the optimization returns exactly what the first restart alone
    gives."""
    x, y = _data()
    tx, ty = t(x), t(y)
    one = {k: torch.tensor([v]) for k, v in THETA.items()}
    args = (1, "relu", 512, "nngp", 4, 0.1, 1e-12)
    want = H._optimize(tx, ty, one, *args)
    real = torch.linalg.cholesky_ex

    def fail_second(a, **kw):
        ell, info = real(a, **kw)
        if ell.dim() == 3 and ell.shape[0] == 2:
            ell, info = ell.clone(), info.clone()
            ell[1] = 0.5
            info[1] = 1
        return ell, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", fail_second)
    two = {k: v.repeat(2) for k, v in one.items()}
    val = _port_loss("exact", "nngp", "relu", 1, x, y)(two)
    assert np.isfinite(float(val[0])) and np.isnan(float(val[1]))
    got = H._optimize(tx, ty, two, *args)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    for k in one:
        assert torch.equal(got[0][k], want[0][k])


# ------------------------------------------------- Adam and apply_if_finite
def test_guarded_adam_matches_optax_apply_if_finite():
    """A toy quadratic, 3 restarts, with non-finite gradients injected:
    restart 1 once (rejected), restart 2 for 11 steps in a row (the 9th
    and later are applied anyway and poison it, as in optax), restart 0
    never. The port's parameters follow optax.apply_if_finite(adam, 8)
    under vmap (rtol 1e-12)."""
    rng = np.random.default_rng(0)
    target = {"a": rng.normal(size=(3,)), "s": rng.normal(size=(3, 4))}
    theta0 = {"a": np.zeros(3), "s": np.ones((3, 4))}
    bad = {(5, 1)} | {(j, 2) for j in range(10, 21)}

    def grad_of(theta, step):
        g = {k: 2.0 * (np.asarray(theta[k]) - target[k]) for k in theta}
        for (j, r) in bad:
            if j == step:
                g["s"] = g["s"].copy()
                g["s"][r, 1] = np.nan if r == 2 else np.inf
        return g

    opt = optax.apply_if_finite(optax.adam(0.1), max_consecutive_errors=8)
    jtheta = {k: jnp.asarray(v) for k, v in theta0.items()}
    jstate = jax.vmap(opt.init)(jtheta)
    update = jax.jit(jax.vmap(opt.update))
    ptheta = {k: torch.tensor(v) for k, v in theta0.items()}
    padam = H._GuardedAdam(ptheta, 0.1)
    for step in range(30):
        jg = grad_of(jtheta, step)
        upd, jstate = update({k: jnp.asarray(v) for k, v in jg.items()},
                             jstate, jtheta)
        jtheta = optax.apply_updates(jtheta, upd)
        pg = grad_of({k: n(v) for k, v in ptheta.items()}, step)
        ptheta = padam.step(ptheta, {k: torch.tensor(v)
                                     for k, v in pg.items()},
                            torch.ones(3, dtype=torch.bool))
        for k in theta0:
            np.testing.assert_allclose(n(ptheta[k]), np.asarray(jtheta[k]),
                                       rtol=1e-12, atol=1e-300,
                                       err_msg=f"{k} at step {step}")
    s = n(ptheta["s"])
    assert np.isnan(s[2, 1]) and np.isfinite(np.delete(s.ravel(), 9)).all()
    assert n(padam.count).tolist() == [30, 29, 22]


def test_guarded_adam_rejects_a_nan_loss_with_finite_gradients():
    theta = {"a": torch.zeros(2)}
    adam = H._GuardedAdam(theta, 0.1)
    out = adam.step(theta, {"a": torch.ones(2)},
                    torch.tensor([True, False]))
    assert float(out["a"][0]) == pytest.approx(-0.1)
    assert float(out["a"][1]) == 0.0
    assert n(adam.count).tolist() == [1, 0]


# ------------------------------------------------------ the learn itself
CONFIGS = {
    "scalar-nngp": dict(get="nngp", depth=1, activation="relu"),
    "scalar-ntk": dict(get="ntk", depth=2, activation="erf"),
    "ard": dict(get="nngp", depth=1, activation="relu", ard=True),
    "dtc": dict(get="nngp", depth=1, activation="relu", objective="dtc",
                dtc_m=24),
}


@pytest.fixture(scope="module")
def learned():
    """{config: (jax result, port result)}: 20 steps, 3 restarts, a
    96-row subsample of 128 rows."""
    x, y = _data(128, seed=3)
    out = {}
    for name, kw in CONFIGS.items():
        kw = dict(kw, steps=20, max_points=96, seed=4)
        out[name] = (JH.fit_kernel_hyperparams(x, y, **kw),
                     H.fit_kernel_hyperparams(x, y, device="cpu", **kw))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_kernel_hyperparams_matches_jax(learned, name):
    jres, res = learned[name]
    for field in ("w0", "w", "b", "diag_reg"):
        np.testing.assert_allclose(getattr(res, field), getattr(jres, field),
                                   rtol=1e-6, err_msg=field)
    assert abs(res.log_evidence - jres.log_evidence) <= 1e-6
    np.testing.assert_allclose(res.nll_history, np.asarray(jres.nll_history),
                               rtol=1e-8)
    assert res.nll_history.shape == (20,)
    if jres.feature_scale is None:
        assert res.feature_scale is None
    else:
        np.testing.assert_allclose(res.feature_scale, jres.feature_scale,
                                   rtol=1e-6)
    for field in ("num_points", "depth", "activation", "objective", "get",
                  "num_features"):
        assert getattr(res, field) == getattr(jres, field), field
    assert res.spec.layers[0].w_std == res.w0
    assert res.spec_params().keys() == jres.spec_params().keys()
    for k, v in jres.spec_params().items():
        np.testing.assert_allclose(res.spec_params()[k], v, rtol=1e-6)
    assert res.fit_kwargs().keys() == jres.fit_kwargs().keys()


def test_artifacts_load_in_either_package_and_serve_the_same(learned,
                                                             tmp_path,
                                                             monkeypatch):
    """A JAX-written artifact loads in the port and the reverse; the ARD
    artifact fitted by each package on its scaled rows predicts the same
    (rtol 1e-9)."""
    jres, res = learned["ard"]
    jres.save(str(tmp_path / "jax.json"))
    res.save(str(tmp_path / "port.json"))
    back = H.HyperoptResult.load(str(tmp_path / "jax.json"))
    jback = JH.HyperoptResult.load(str(tmp_path / "port.json"))
    assert json.loads(back.to_json()) == json.loads(jres.to_json())
    assert json.loads(jback.to_json()) == json.loads(res.to_json())
    assert jax_spec(back.spec).layers == jres.spec.layers
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 16)   # the exact diagonal
    x, y = _data(64, seed=5)
    xq = rows(16, seed=6, special=False)
    jpost = JP.fit_gp(jres.spec, jres.scale_inputs(x), y,
                      **jres.fit_kwargs())
    post = fit_gp(back.spec, t(back.scale_inputs(x)), t(y),
                  **back.fit_kwargs())
    np.testing.assert_array_equal(back.scale_inputs(x),
                                  np.asarray(jres.scale_inputs(x)))
    assert torch.equal(back.scale_inputs(t(x)), t(back.scale_inputs(x)))
    got = post.predict_mean_std(t(back.scale_inputs(xq)))
    want = jpost.predict_mean_std(jres.scale_inputs(xq))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g).ravel(), np.asarray(w).ravel(),
                                   rtol=1e-9)


def test_select_kernel_ranking_matches_jax():
    x, y = _data(128, seed=3)        # the data and learn of `learned`
    kw = dict(depths=(1, 2), activations=("relu",), steps=20,
              max_points=96, seed=4)
    jlines, lines = [], []
    jbest, jall = JH.select_kernel(x, y, verbose=jlines.append, **kw)
    best, allres = H.select_kernel(x, y, verbose=lines.append, device="cpu",
                                   **kw)
    assert [(r.depth, r.activation) for r in allres] == \
        [(r.depth, r.activation) for r in jall]
    np.testing.assert_allclose([r.log_evidence for r in allres],
                               [r.log_evidence for r in jall], rtol=1e-9)
    assert (best.depth, best.activation) == (jbest.depth, jbest.activation)
    assert lines == jlines


def test_guards_raise_like_jax():
    x, y = _data(128, seed=3)
    bad = x.copy()
    bad[:, 0] = np.nan
    kw = dict(steps=20, max_points=96, seed=4)   # `learned`'s compile
    with pytest.raises(FloatingPointError, match="diverged"):
        JH.fit_kernel_hyperparams(bad, y, **kw)
    with pytest.raises(FloatingPointError, match="diverged"):
        H.fit_kernel_hyperparams(bad, y, device="cpu", **kw)
    big = (x * 2.0 ** 12).astype(np.float32)
    with pytest.raises(ValueError, match="overflows squared fp32"):
        JH.fit_kernel_hyperparams(big, y.astype(np.float32), steps=2)
    with pytest.raises(ValueError, match="overflows squared fp32"):
        H.fit_kernel_hyperparams(big, y.astype(np.float32), steps=2,
                                 device="cpu")
    # a taming init_feature_scale passes the guard
    res = H.fit_kernel_hyperparams(
        big[:32], y[:32].astype(np.float32), steps=2, ard=True,
        init_feature_scale=np.full(x.shape[1], 2.0 ** -12), device="cpu")
    assert res.feature_scale.dtype == np.float64
    assert res.nll_history.dtype == np.float32
    # the mesh path takes the DTC objective only, in both packages
    from nngp_tpu.parallel import make_mesh as jax_mesh
    with pytest.raises(ValueError, match="requires objective='dtc'"):
        JH.fit_kernel_hyperparams(x, y, steps=2, mesh=jax_mesh(2))
    with pytest.raises(ValueError, match="requires objective='dtc'"):
        H.fit_kernel_hyperparams(x, y, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="objective must be"):
        H.fit_kernel_hyperparams(x, y, objective="elbo", device="cpu")
    with pytest.raises(ValueError, match="device="):
        H.fit_kernel_hyperparams(x, y)
