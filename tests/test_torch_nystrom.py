"""The port's Nystrom/DTC tier (`nngp_tpu_torch.gp.nystrom`) against the
JAX package's (`nngp_tpu/gp/nystrom.py`), on the CPU.

The rows are integers in [0, 1000) at d = 20, so sums of squares and K0
are exact in fp64 and both packages see the same K0. Tolerances, and why:

  - nngp, fp64: rtol 1e-9 on predictions, moments and evidence (the two
    packages sum the same products in different orders; the whitening
    amplifies entry rounding by up to sqrt(lam_max / lam_cut)).
  - ntk, fp64: rtol 1e-7. Every inducing row meets itself at rho = 1, in
    K_mm and in its own panel, where the generic NTK dual evaluates acos
    at 1 - ulp; each package rounds cos t = k12 / sqrt(k11 k22) its own
    way, so those entries differ by ~sqrt(eps) ~ 1e-8 relative (a property
    both packages share, ROADMAP Queue C).
  - The bases are compared through basis-free quantities (W C W^T, W b,
    W ic ic^T W^T): an eigh basis is unique only up to column signs and
    ic only up to an orthogonal factor.
  - moments='df64' (fp64 here) against JAX's fp64 pipeline on the
    fp32-cast rows: rtol 1e-4 of the largest entry on predictions, 1e-5
    on the moments: the port rounds ic, beta and the test projections to
    fp32, as JAX's df64 tier does, and the fp32 predict sums terms ~100x
    larger than the NTK covariance they leave.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.nystrom as JN
from nngp_tpu_torch.gp import fit_gp, fit_nystrom
from nngp_tpu_torch.gp import nystrom as TN
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp, \
    reference_kernel
from tests.test_torch_common import jax_spec, n

RTOL = {"nngp": 1e-9, "ntk": 1e-7}


def _data(n_rows=150, n_test=30, d=20, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1000, (n_rows, d)).astype(dtype)
    xt = rng.integers(0, 1000, (n_test, d)).astype(dtype)
    y = rng.uniform(0.0, 16.0, (n_rows, 1)).astype(dtype)
    return x, y, xt


def _close(got, want, rtol):
    got, want = n(got), n(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _basis_free(post, lo=lambda name: None):
    """(W C W^T, W b, W ic ic^T W^T[, W_K M1 W^T]) in fp64: invariant to
    the basis's column signs and to ic's orthogonal freedom. `lo` gives a
    JAX df64 field's tail."""
    def f64(name):
        v = np.asarray(n(getattr(post, name)), np.float64)
        tail = lo(name)
        return v if tail is None else v + np.asarray(tail, np.float64)

    w, c, b = f64("w_solve"), f64("c_raw"), f64("b_w")
    ic = np.asarray(n(post.ic), np.float64)
    out = [w @ c @ w.T, w @ b, w @ ic @ ic.T @ w.T]
    if post.m1_w is not None:
        out.append(f64("w_kmm") @ f64("m1_w") @ w.T)
    return out


def _predictions(post, xt):
    xt_in = torch.as_tensor(xt) if isinstance(post, TN.NystromPosterior) \
        else jnp.asarray(xt)
    full = post.predict(xt_in, compute_cov=True)
    diag = post.predict(xt_in, compute_cov="diag")
    mean_only = post.predict(xt_in, compute_cov=False)
    return [*full, *diag, mean_only, *post.predict_mean_std(xt_in),
            *post.predict_mean_std_chunked(xt, chunk=7)]


def _evidence(post):
    return [post.log_evidence(), post.capacity_gap(), post.elbo()]


def test_select_inducing_matches_jax():
    for n_rows, m, seed in ((100, 30, 0), (100, 30, 5), (90000, 2048, 0),
                            (10, 32, 0)):
        np.testing.assert_array_equal(TN.select_inducing(n_rows, m, seed),
                                      JN.select_inducing(n_rows, m, seed))


def test_default_rank_rtol_matches_jax():
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.float64, jnp.float64)):
        for moments in ("fp32", "df64"):
            assert (TN._default_rank_rtol(tdt, moments)
                    == JN._default_rank_rtol(jdt, moments))


@pytest.mark.parametrize("absolute", [False, True], ids=["rel", "abs"])
@pytest.mark.parametrize("whiten", ["chol", "eigh"])
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fit_predict_evidence_match_jax(get, whiten, absolute):
    spec = reference_kernel()
    x, y, xt = _data()
    kw = dict(num_inducing=40, get=get, whiten=whiten, panel_size=64,
              diag_reg=1e-2 if absolute else 1e-3,
              diag_reg_absolute_scale=absolute)
    jpost = JN.fit_nystrom(jax_spec(spec), x, y, **kw)
    post = fit_nystrom(spec, x, y, device="cpu", **kw)
    assert post.rank == jpost.rank and post.num_train == 150
    assert post.finalize == "host"
    rtol = RTOL[get]
    for got, want in zip(_predictions(post, xt), _predictions(jpost, xt)):
        _close(got, want, rtol)
    for got, want in zip(_basis_free(post), _basis_free(jpost)):
        _close(got, want, rtol)
    for name in ("reg", "diag_sum", "yty"):
        _close(getattr(post, name), getattr(jpost, name), rtol)
    np.testing.assert_allclose(_evidence(post), _evidence(jpost), rtol=rtol)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_input_scale_and_inducing_rows_match_jax(get):
    """A forced prescale and explicit inducing rows (raw units), on a
    depth-2 spec; the ntk tolerance also covers the second layer's rho = 1
    entries."""
    spec = KernelSpec(mlp(2))
    x, y, xt = _data(seed=1)
    rows = x[::5][:30] + 0.5
    kw = dict(get=get, input_scale=64.0, inducing_rows=rows)
    jpost = JN.fit_nystrom(jax_spec(spec), x, y, **kw)
    post = fit_nystrom(spec, x, y, device="cpu", **kw)
    rtol = RTOL[get] * (10 if get == "ntk" else 1)
    for got, want in zip(_predictions(post, xt), _predictions(jpost, xt)):
        _close(got, want, rtol)
    np.testing.assert_allclose(_evidence(post), _evidence(jpost), rtol=rtol)
    np.testing.assert_array_equal(n(post.x_m), np.asarray(jpost.x_m))


def _probe_rows(case):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1000, (150, 20))
    if case == "fp32_negative_max":
        x = (x - 500.0) * 6e3
        x[17, 3] = -5.0e6
        return x.astype(np.float32)
    if case == "fp32_below_threshold":
        return x.astype(np.float32)
    if case == "fp32_not_equivariant":
        return (x * 6e3).astype(np.float32)
    return (x * 6e3).astype(np.float64)


@pytest.mark.parametrize("case,scale", [
    ("fp32_negative_max", 2.0 ** 23), ("fp32_below_threshold", 1.0),
    ("fp32_not_equivariant", 1.0), ("fp64", 1.0)])
def test_fit_probes_its_device_rows_for_the_input_scale(monkeypatch, case,
                                                        scale):
    """fit_nystrom on numpy rows takes max|x| from the tensor it holds on
    its device, never the caller's array, and gets numpy's scale: the fit
    equals, bit for bit, one given that scale."""
    spec = KernelSpec(mlp(1, width=64, b_std=0.1 if case ==
                          "fp32_not_equivariant" else 0.0))
    x = _probe_rows(case)
    y = np.random.default_rng(12).uniform(0.0, 16.0, (len(x), 1)).astype(
        x.dtype)
    want = TN._auto_input_scale(x, spec.layers)
    assert want == scale
    probe, seen = TN._auto_input_scale, []

    def on_tensors_only(rows, layers):
        assert isinstance(rows, torch.Tensor)
        seen.append(rows)
        return probe(rows, layers)

    monkeypatch.setattr(TN, "_auto_input_scale", on_tensors_only)
    monkeypatch.setattr(TN, "_BASES_CACHE", {})
    kw = dict(num_inducing=24, panel_size=40, seed=3, device="cpu")
    post = fit_nystrom(spec, x, y, **kw)
    assert len(seen) == 1 and post.input_scale == want
    TN._BASES_CACHE.clear()
    given = fit_nystrom(spec, x, y, input_scale=want, **kw)
    assert len(seen) == 1
    for name in ("x_m", "w_solve", "c_raw", "b_w", "ic", "beta_w", "reg"):
        assert torch.equal(getattr(post, name), getattr(given, name)), name


@pytest.mark.parametrize("fill", [
    "inf", "-inf", "nan", "nan_and_large", "empty", "power_of_two", "large"])
def test_the_device_probe_gives_numpy_s_input_scale(fill):
    """The probe alone on the tensor the fit makes of numpy rows, against
    the same probe on the array: non-finite maxima map to 1.0, an empty
    array reads 0.0 (scale 1.0), powers of two are kept."""
    layers = mlp(1)
    x = np.random.default_rng(13).uniform(-1e3, 1e3, (40, 7)).astype(
        np.float32)
    if fill == "empty":
        x = x[:0]
    elif fill == "power_of_two":
        x[5, 2] = -2.0 ** 21
    elif fill == "large":
        x[5, 2] = 3.3e7
    else:
        x[5, 2] = {"inf": np.inf, "-inf": -np.inf}.get(fill, np.nan)
        if fill == "nan_and_large":
            x[9, 1] = 3.3e7
    want = TN._auto_input_scale(x, layers)
    got = TN._auto_input_scale(TN._as_tensor(x, "cpu"), layers)
    assert got == want
    assert want == {"power_of_two": 2.0 ** 21,
                    "large": 2.0 ** 25}.get(fill, 1.0)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_extend_equals_refit_and_forget_inverts(get):
    """Moments are row sums: extend equals a refit on the concatenated
    rows with the same inducing rows and ridge, and forget(extend(rows))
    is the base posterior; both as in JAX."""
    spec = reference_kernel()
    x, y, xt = _data(n_rows=160, seed=2)
    base = fit_nystrom(spec, x[:120], y[:120], num_inducing=40, get=get,
                       diag_reg_absolute_scale=True, diag_reg=10.0,
                       panel_size=50, device="cpu")
    ext = base.extend(x[120:], y[120:])
    assert ext.num_train == 160 and base.num_train == 120
    refit = fit_nystrom(spec, x, y, inducing_rows=n(base.x_m), get=get,
                        diag_reg_absolute_scale=True, diag_reg=10.0,
                        device="cpu")
    for got, want in zip(_predictions(ext, xt), _predictions(refit, xt)):
        _close(got, want, 1e-9)
    np.testing.assert_allclose(_evidence(ext), _evidence(refit), rtol=1e-9)
    jext = JN.fit_nystrom(jax_spec(spec), x[:120], y[:120], num_inducing=40,
                          get=get, diag_reg_absolute_scale=True,
                          diag_reg=10.0, panel_size=50).extend(x[120:],
                                                               y[120:])
    for got, want in zip(_predictions(ext, xt), _predictions(jext, xt)):
        _close(got, want, RTOL[get])
    back = ext.forget(x[120:], y[120:])
    assert back.num_train == 120
    for got, want in zip(_predictions(back, xt), _predictions(base, xt)):
        _close(got, want, 1e-9)
    _close(back.yty, base.yty, 1e-12)
    with pytest.raises(ValueError, match="exceeds num_train"):
        base.forget(np.concatenate([x, x]), np.concatenate([y, y]))


def test_panel_size_invariance():
    spec = reference_kernel()
    x, y, xt = _data(n_rows=100, seed=3)
    p1 = fit_nystrom(spec, x, y, num_inducing=30, panel_size=7, device="cpu")
    p2 = fit_nystrom(spec, x, y, num_inducing=30, panel_size=1000,
                     device="cpu")
    for got, want in zip(_predictions(p1, xt), _predictions(p2, xt)):
        _close(got, want, 1e-9)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_full_inducing_recovers_exact_fit_gp(get):
    """With every train row inducing, DTC is the exact posterior (up to the
    rank cut): the port's own `fit_gp`, at the JAX test's tolerances."""
    spec = reference_kernel()
    x, y, xt = _data(n_rows=96, seed=4)
    exact = fit_gp(spec, x, y, get=get, device="cpu")
    approx = fit_nystrom(spec, x, y, num_inducing=96, get=get,
                         rank_rtol=1e-14, panel_size=37, device="cpu")
    m0, s0 = exact.predict_mean_std(torch.as_tensor(xt))
    m1, s1 = approx.predict_mean_std(torch.as_tensor(xt))
    np.testing.assert_allclose(n(m1), n(m0), rtol=1e-6,
                               atol=1e-8 * float(np.max(np.abs(n(m0)))))
    np.testing.assert_allclose(n(s1), n(s0), rtol=1e-5,
                               atol=1e-7 * float(np.max(n(s0))))


def test_grow_inducing_matches_fresh_fit_and_elbo_is_monotone():
    spec = KernelSpec(mlp(2))
    x, y, xt = _data(n_rows=200, seed=5)
    post = fit_nystrom(spec, x, y, num_inducing=24, seed=1, input_scale=4.0,
                       device="cpu")
    extra = x[180:196]
    grown = post.grow_inducing(extra, x, y)
    assert grown.num_inducing == 40 and grown.input_scale == 4.0
    fresh = fit_nystrom(spec, x, y, input_scale=4.0, device="cpu",
                        inducing_rows=np.concatenate(
                            [x[TN.select_inducing(200, 24, 1)], extra]))
    for got, want in zip(_predictions(grown, xt), _predictions(fresh, xt)):
        _close(got, want, 1e-10)
    assert grown.elbo() >= post.elbo() - 1e-6 * abs(post.elbo())
    jgrown = JN.fit_nystrom(jax_spec(spec), x, y, num_inducing=24, seed=1,
                            input_scale=4.0).grow_inducing(extra, x, y)
    np.testing.assert_allclose(_evidence(grown), _evidence(jgrown),
                               rtol=1e-9)
    exact = fit_gp(spec, x, y, input_scale=4.0, device="cpu")
    assert grown.elbo() <= exact.log_marginal_likelihood() + 1e-6


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_finalize_device_matches_host(get):
    """finalize='device' (the fp64 solve stage and whitening basis on the
    posterior's device, here the CPU) against 'host', through fit and
    extend; and the 'auto' rule: 'host' for a CPU posterior."""
    spec = reference_kernel()
    x, y, xt = _data(n_rows=100, seed=6)
    for dtype in (np.float64, np.float32):
        xd, yd, xtd = x.astype(dtype), y.astype(dtype), xt.astype(dtype)
        host = fit_nystrom(spec, xd[:70], yd[:70], num_inducing=40, get=get,
                           device="cpu")
        dev = fit_nystrom(spec, xd[:70], yd[:70], num_inducing=40, get=get,
                          finalize="device", device="cpu")
        assert host.finalize == "host" and dev.finalize == "device"
        rtol = 1e-8 if dtype == np.float64 else 2e-3
        for a, b in ((host, dev), (host.extend(xd[70:], yd[70:]),
                                   dev.extend(xd[70:], yd[70:]))):
            for got, want in zip(_predictions(b, xtd), _predictions(a, xtd)):
                _close(got, want, rtol)
    assert TN._resolve_finalize("auto", "cpu") == "host"
    assert TN._resolve_finalize("auto", "cuda") == "device"
    with pytest.raises(ValueError, match="finalize"):
        fit_nystrom(spec, x, y, num_inducing=10, finalize="gpu",
                    device="cpu")


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_df64_moments_match_the_jax_fp64_pipeline(get):
    """moments='df64' runs in native fp64: on fp32 rows it must give what
    JAX's fp64 pipeline gives on the same rows cast to fp64 (the oracle
    JAX's own df64 tier reproduces), at the same rank cut and prescale."""
    spec = reference_kernel()
    x, y, xt = _data(n_rows=200, seed=7, dtype=np.float32)
    kw = dict(num_inducing=48, get=get, rank_rtol=1e-12, input_scale=1.0,
              panel_size=64)
    post = fit_nystrom(spec, x, y, moments="df64", device="cpu", **kw)
    assert post.moments == "df64" and post.rank_rtol == 1e-12
    assert post.w_solve.dtype == torch.float64
    assert post.c_raw.dtype == torch.float64 and post.ic.dtype == torch.float32
    oracle = JN.fit_nystrom(jax_spec(spec), x.astype(np.float64),
                            y.astype(np.float64), **kw)
    for got, want in zip(_predictions(post, xt),
                         _predictions(oracle, xt.astype(np.float64))):
        _close(got, want, 1e-4)
    for got, want in zip(_basis_free(post), _basis_free(oracle)):
        _close(got, want, 1e-5)
    np.testing.assert_allclose(_evidence(post), _evidence(oracle), rtol=1e-6)
    # extend and forget stay fp64 through the moments
    ext = post.extend(x[:16], y[:16])
    assert ext.c_raw.dtype == torch.float64
    back = ext.forget(x[:16], y[:16])
    for got, want in zip(_predictions(back, xt), _predictions(post, xt)):
        _close(got, want, 1e-5)


def test_df64_moments_match_jax_df64_on_a_tiny_case():
    """Against JAX's own emulated-fp64 tier once (it is slow on the CPU):
    the same model to the fp32 rounding of the predict."""
    spec = reference_kernel()
    x, y, xt = _data(n_rows=60, seed=8, dtype=np.float32)
    kw = dict(num_inducing=16, get="ntk", input_scale=1.0, moments="df64")
    post = fit_nystrom(spec, x, y, device="cpu", **kw)
    jpost = JN.fit_nystrom(jax_spec(spec), x, y, **kw)
    m0, s0 = jpost.predict_mean_std(jnp.asarray(xt))
    m1, s1 = post.predict_mean_std(torch.as_tensor(xt))
    _close(m1, m0, 1e-4)
    _close(s1, s0, 1e-3)
    tails = {"c_raw": jpost.c_lo, "b_w": jpost.b_lo, "m1_w": jpost.m1_lo,
             "w_solve": jpost.w_solve_lo, "w_kmm": jpost.w_kmm_lo}
    for got, want in zip(_basis_free(post),
                         _basis_free(jpost, lambda k: tails.get(k))):
        _close(got, want, 1e-4)


class _CudaMesh:
    device_type = "cuda"


def test_errors():
    spec = reference_kernel()
    x, y, _ = _data(n_rows=32)
    kw = dict(num_inducing=16, device="cpu")
    for bad, err, match in (
            (dict(get="gp"), ValueError, "get"),
            (dict(whiten="qr"), ValueError, "whiten"),
            (dict(inducing="kmeans"), ValueError, "inducing"),
            (dict(precision="default"), ValueError, "precision"),
            (dict(precision="HIGH"), ValueError, "precision"),
            (dict(mesh=_CudaMesh()), ValueError, "mesh is a cuda mesh"),
            (dict(moments="bf16"), ValueError, "moments"),
            (dict(moments="df64"), ValueError, "df64"),
            (dict(finalize="tpu"), ValueError, "finalize")):
        with pytest.raises(err, match=match):
            fit_nystrom(spec, x, y, **kw, **bad)
    with pytest.raises(ValueError, match="device="):
        fit_nystrom(spec, x, y, num_inducing=16)
    # precision='high' is ported (tests/test_torch_matmul_3xtf32.py)
    high = fit_nystrom(spec, x.astype(np.float32), y.astype(np.float32),
                       precision="high", **kw)
    assert high.precision == "high"
    assert len(TN.select_inducing_rpchol(
        spec, x.astype(np.float32), 8, precision="high", device="cpu")) == 8
    zeros = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="no eigenvalue"):
        TN._whiten_basis(zeros, 1e-8)
    with pytest.raises(ValueError, match="non-positive"):
        TN._whiten_basis_chol(zeros, 1e-8)
    post = fit_nystrom(spec, x, y, **kw)
    with pytest.raises(ValueError, match="compute_cov"):
        post.predict(x, compute_cov="full")
    with pytest.raises(ValueError, match="evidence tracking"):
        import dataclasses
        dataclasses.replace(post, yty=None).log_evidence()


# ------------------------------------------------- forest_2048 golden pins
_FOREST_2048_PINS = (3.5658, 46.3905)   # tests/test_parity_gate.py:108-115


@pytest.fixture(scope="module")
def forest_2048():
    from nngp_tpu_torch.data.workload import load_single_table_workload
    from nngp_tpu_torch.eval.splits import train_test_val_split

    x, y, infos, _ = load_single_table_workload("workloads/forest_data",
                                                dtype=np.float64)
    x_tr, y_tr, _, x_te, y_te, *_ = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos)
    return x_tr[:2048], y_tr[:2048], x_te, y_te


@pytest.mark.parametrize("dtype,moments", [(np.float64, "fp32"),
                                           (np.float32, "df64")],
                         ids=["fp64", "fp32_df64"])
def test_forest_2048_pins(forest_2048, dtype, moments):
    """The two Nystrom golden pins of the parity gate (n_tr = 2048, m =
    256), reproduced by the port on the CPU at rel 2e-3."""
    from nngp_tpu_torch.eval.qerror import symmetric_qerror

    x_tr, y_tr, x_te, y_te = forest_2048
    post = fit_nystrom(reference_kernel(), x_tr.astype(dtype),
                       y_tr.astype(dtype), num_inducing=256, diag_reg=1e-3,
                       seed=0, moments=moments, device="cpu")
    mean, _ = post.predict_mean_std(torch.as_tensor(x_te.astype(dtype)))
    q = symmetric_qerror(n(mean).ravel() - np.asarray(y_te).ravel())
    assert float(np.median(q)) == pytest.approx(_FOREST_2048_PINS[0],
                                                rel=2e-3)
    assert float(np.quantile(q, 0.95)) == pytest.approx(_FOREST_2048_PINS[1],
                                                        rel=2e-3)
