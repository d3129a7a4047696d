"""Padded posteriors, the serving buckets and the shape-stable surfaces of
the port (`fit_gp(pad_to=)`, `GPPosterior.extend(bucket=)`,
`Estimator(pad_slots=)`, `Estimator.warmup`, `ActiveLearner(
pad_acquisitions=)`, `serve_demo --pad_slots`, `active_train
--pad_acquisitions`) side by side with the JAX package's, fp64 on the CPU
(`tests/test_posterior.py` and `tests/test_active_serve.py` hold the JAX
package to the same bounds).

Bounds, the JAX package's own: a padded posterior against the dense one
and against JAX's padded one, mean rtol 1e-9, std rtol 1e-7, evidence
rtol 1e-9. The CPU runs the serving buckets eagerly (`serve/graphs.py`);
their CUDA graphs are held to the eager predict by `chip_smoke.py`.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.posterior as JP
from nngp_tpu.active import ActiveLearner as JaxLearner
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.active import ActiveLearner
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp import posterior as TP
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.ops.gram_cuda import gram_sym
from nngp_tpu_torch.ops.linalg import FactorError
from nngp_tpu_torch.serve import Estimator
from nngp_tpu_torch.serve import graphs
from tests.test_active_serve import _toy_schema_files
from tests.test_torch_common import jax_spec, n, t

SPEC = KernelSpec(mlp(2))
Q = ["ta,tb@x,3.0,1.0@@ta,tb,id", "ta,tb@x,7.5,0.5@@ta,tb,id",
     "ta,tb@@y,0.9,0.1@ta,tb,id"]
FEEDBACK = ["ta,tb@x,3.0,1.0@@ta,tb,id@2000",
            "ta,tb@x,8.0,2.0@@ta,tb,id@6000",
            "ta,tb@x,6.0,-1.0@@ta,tb,id@4500"]


@pytest.fixture(scope="module", autouse=True)
def jax_exact_diag():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_FUSED_FIT_MIN_N", 16)
        yield


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


def _data(seed=41, n_train=100, n_test=11, d=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1000, (n_train, d)),
            rng.standard_normal((n_train, 1)),
            rng.uniform(0, 1000, (n_test, d)), rng)


def _same(got, want, mean_rtol=1e-9, std_rtol=1e-7):
    (m, s), (wm, ws) = got, want
    m, s, wm, ws = (np.ravel(n(a)) for a in (m, s, wm, ws))
    np.testing.assert_allclose(m, wm, rtol=mean_rtol,
                               atol=mean_rtol * np.max(np.abs(wm)))
    np.testing.assert_allclose(s, ws, rtol=std_rtol,
                               atol=std_rtol * np.max(np.abs(ws)))


def _ptrs(post):
    return [a.data_ptr() for a in (post.x_train, post.y_train, post.l,
                                   post.alpha, post.row_mask)]


# ------------------------------------------------------------ posterior
def test_padded_fit_matches_dense_and_jax():
    x, y, xt, _ = _data()
    pad = fit_gp(SPEC, t(x), t(y), pad_to=160)
    dense = fit_gp(SPEC, t(x), t(y))
    jpad = JP.fit_gp(jax_spec(SPEC), jnp.asarray(x), jnp.asarray(y),
                     pad_to=160)
    assert pad.n_real == int(jpad.n_real) == 100
    assert pad.num_train == 100 and pad.num_padded == 160
    assert float(pad.reg) == float(dense.reg)      # the real rows' ridge
    _same(pad.predict_mean_std(t(xt)), dense.predict_mean_std(t(xt)))
    _same(pad.predict_mean_std(t(xt)),
          jpad.predict_mean_std(jnp.asarray(xt)))
    np.testing.assert_allclose(pad.log_marginal_likelihood(),
                               dense.log_marginal_likelihood(), rtol=1e-9)
    np.testing.assert_allclose(pad.log_marginal_likelihood(),
                               jpad.log_marginal_likelihood(), rtol=1e-9)
    # inert rows: unit factor rows, zero labels and alpha, masked out
    assert torch.equal(pad.l[100:, 100:], torch.eye(60, dtype=pad.l.dtype))
    assert not pad.l[100:, :100].any() and not pad.alpha[100:].any()
    assert n(pad.row_mask).tolist() == [1.0] * 100 + [0.0] * 60
    # the full covariance too (greedy selection reads it)
    _, cov = pad.predict(t(xt), compute_cov=True)
    _, dcov = dense.predict(t(xt), compute_cov=True)
    np.testing.assert_allclose(n(cov), n(dcov), rtol=1e-7,
                               atol=1e-9 * float(torch.max(dcov.abs())))


def test_padded_fit_with_an_fp32_prescale():
    """fp32 with a pinned prescale (2.0): the padded fit is as close to
    the fp64 fit as the dense fp32 one (JAX's test_padded_fit_with_input_
    scale), and its fp32 variance reads the masked raw-row kernels."""
    x, y, xt, _ = _data(seed=33, n_train=64, n_test=7, d=4)
    f32 = lambda a: t(np.asarray(a, np.float32))  # noqa: E731
    oracle = fit_gp(SPEC, t(x), t(y), input_scale=2.0)
    dense = fit_gp(SPEC, f32(x), f32(y), input_scale=2.0)
    pad = fit_gp(SPEC, f32(x), f32(y), input_scale=2.0, pad_to=96)
    assert pad._raw64 and float(pad.reg) == float(dense.reg)
    m_o = n(oracle.predict_mean_std(t(xt))[0])
    m_d = n(dense.predict_mean_std(f32(xt))[0])
    m_p, s_p = (n(a) for a in pad.predict_mean_std(f32(xt)))
    s_d = n(dense.predict_mean_std(f32(xt))[1])
    err_d, err_p = np.max(np.abs(m_d - m_o)), np.max(np.abs(m_p - m_o))
    assert err_p <= 3 * max(err_d, 1e-3), (err_p, err_d)
    np.testing.assert_allclose(s_p, s_d, rtol=1e-5)
    ext = pad.extend(f32(xt), torch.zeros((7, 1)))
    assert ext is pad and ext.num_train == 71 and ext.num_padded == 96


def _whole_padded_fit(x, y, pad_to, input_scale, diag_reg=1e-3):
    """The reference for the padded fit's factor: the inert-padded Gram
    [K + rI, 0; 0, I] built at all pad_to rows (zero fill, the real block
    from `gram_sym`, a unit pad diagonal), factored whole by `cholesky_ex`
    and solved whole for alpha. Returns (factor, info, alpha)."""
    x = t(x) * (1.0 / input_scale)
    y, nr = t(y), x.shape[0]
    diag = TP.diag_eval(SPEC.layers, x, ("nngp", "ntk"))
    reg = TP.solve_ridge(diag, "nngp", diag_reg, False)
    k = x.new_zeros((pad_to, pad_to))
    gram_sym(SPEC, x, "nngp", diag_add=reg, diag=diag, out=k[:nr, :nr])
    k.diagonal()[nr:] = 1.0
    l, info = torch.linalg.cholesky_ex(k)
    y = torch.cat([y, y.new_zeros((pad_to - nr, 1))])
    z = torch.linalg.solve_triangular(l, y, upper=False)
    return l, int(info), torch.linalg.solve_triangular(l.mT, z, upper=True)


@pytest.mark.parametrize("dtype, input_scale", [(np.float64, 1.0),
                                                (np.float32, 2.0)])
def test_the_padded_factor_matches_the_whole_padded_factor(dtype,
                                                           input_scale):
    """The padded fit factors and solves its 100 real rows and writes the
    pad beside them: its real block matches the factor of the whole
    160-row padded Gram to rounding (n eps max|L| for the factor,
    eps n / diag_reg max|alpha| for alpha, the Gram's condition), and
    the pad block is exact: a unit diagonal, zeros beside it, zero
    alpha rows. fp64, and fp32 with a pinned prescale."""
    x, y, _, _ = _data()
    x, y = x.astype(dtype), y.astype(dtype)
    pad = fit_gp(SPEC, t(x), t(y), input_scale=input_scale, pad_to=160)
    l, info, alpha = _whole_padded_fit(x, y, 160, input_scale)
    assert info == 0 and pad.l.shape == (160, 160)
    eps = torch.finfo(pad.l.dtype).eps
    torch.testing.assert_close(
        pad.l[:100, :100], l[:100, :100], rtol=0,
        atol=8 * 100 * eps * float(l.abs().max()))
    torch.testing.assert_close(
        pad.alpha[:100], alpha[:100], rtol=0,
        atol=eps * (100 / 1e-3) * float(alpha.abs().max()))
    assert torch.equal(pad.l[100:, 100:], torch.eye(60, dtype=pad.l.dtype))
    assert not pad.l[100:, :100].any() and not pad.l[:100, 100:].any()
    assert not pad.alpha[100:].any() and pad.alpha.shape == (160, 1)


@pytest.mark.parametrize("compute_cov", ["diag", True])
@pytest.mark.parametrize("dtype, input_scale", [(np.float64, 1.0),
                                                (np.float32, 2.0)])
def test_the_live_prefix_predicts_as_the_stripped_posterior(
        dtype, input_scale, compute_cov):
    """A padded predict reads the live prefix of its storage (`live_rows`:
    n_real rounded up to LIVE_STEP): at 300 real rows of 1,100 (k = 512)
    and after in-place extends to 400, 500 and 600 (k = 768), it equals
    the predict of `strip_padding()`, which reads the n_real rows alone.
    Relative, 1e-12 in fp64 and 1e-6 in fp32 (whose variance is fp64,
    `raw_fp64`): the variance to its largest value, the mean to the
    largest sum |K_*t| |alpha| over its row, the scale of a dot product's
    rounding, since the mean's product sums k columns instead of n_real
    and alpha's terms cancel by orders of magnitude."""
    x, y, xt, _ = _data(seed=53, n_train=600, n_test=13)
    cast = lambda a: t(np.asarray(a, dtype))  # noqa: E731
    post = fit_gp(SPEC, cast(x[:300]), cast(y[:300]), pad_to=1100,
                  input_scale=input_scale)
    assert post._raw64 == (dtype == np.float32)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    live = []
    for s in (300, 400, 500, 600):
        if s > 300:
            assert post.extend(cast(x[s - 100:s]), cast(y[s - 100:s]),
                               bucket=128) is post
        live.append(TP.live_rows(post))
        stripped = post.strip_padding()
        got = post.predict(cast(xt), compute_cov)
        want = stripped.predict(cast(xt), compute_cov)
        cross = TP.gram_cross(SPEC, cast(xt) / input_scale,
                              stripped.x_train, "nngp")
        scales = (n(cross.abs() @ stripped.alpha.abs()), n(want[1]))
        for g, w, scale in zip(got, want, scales):
            g, w = n(g).astype(np.float64), n(w).astype(np.float64)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=rtol * np.max(np.abs(scale)))
    assert live == [512, 512, 512, 768] and post.num_train == 600


def test_pad_to_n_is_the_dense_fit_bit_for_bit():
    """pad_to == n: a padded posterior with no pad rows, whose factor,
    alpha and rows are the dense fit's bit for bit."""
    x, y, xt, _ = _data()
    pad = fit_gp(SPEC, t(x), t(y), pad_to=100)
    dense = fit_gp(SPEC, t(x), t(y))
    assert pad.n_real == 100 and pad.num_padded == 100
    for name in ("x_train", "y_train", "l", "alpha", "reg"):
        assert torch.equal(getattr(pad, name), getattr(dense, name)), name
    assert torch.equal(pad.row_mask, torch.ones(100, dtype=torch.float64))
    for a, b in zip(pad.predict_mean_std(t(xt)),
                    dense.predict_mean_std(t(xt))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("diag_reg", [-0.5, -1e-3, -1e-4])
def test_a_padded_fit_that_is_not_positive_definite_fails_at_the_same_order(
        diag_reg):
    """A real block that is not positive definite (a negative ridge)
    raises FactorError at the leading minor where the whole padded
    Gram's factor fails: the pad block cannot fail."""
    x, y, _, _ = _data()
    _, info, _ = _whole_padded_fit(x, y, 160, 1.0, diag_reg=diag_reg)
    assert 0 < info <= 100
    with pytest.raises(FactorError) as err:
        fit_gp(SPEC, t(x), t(y), diag_reg=diag_reg, pad_to=160)
    assert (err.value.op, err.value.order, err.value.n) == ("fit", info, 100)
    assert err.value.diag_reg == diag_reg


def test_the_padded_fit_factors_the_real_rows_only(monkeypatch):
    """pad_to=160, n=100: `cholesky_ex` is handed the (100, 100) ridged
    Gram, not the padded matrix."""
    shapes, factor = [], torch.linalg.cholesky_ex

    def recording(a, *args, **kw):
        shapes.append(tuple(a.shape))
        return factor(a, *args, **kw)

    monkeypatch.setattr(TP.torch.linalg, "cholesky_ex", recording)
    x, y, _, _ = _data()
    pad = fit_gp(SPEC, t(x), t(y), pad_to=160)
    assert shapes == [(100, 100)] and pad.l.shape == (160, 160)


def test_bucketed_extends_write_in_place_and_match_dense_and_jax():
    """bucket=: a 10-row batch rounds up to 64 rows and a 70-row one to
    128; n_real advances by the real rows only, every storage tensor
    keeps its address, and the posterior, its evidence and JAX's padded
    posterior agree. A bucket past the slots falls back to the dense
    extend of the stripped posterior."""
    x, y, xt, rng = _data()
    pad = fit_gp(SPEC, t(x), t(y), pad_to=300)
    dense = fit_gp(SPEC, t(x), t(y))
    jpad = JP.fit_gp(jax_spec(SPEC), jnp.asarray(x), jnp.asarray(y),
                     pad_to=300)
    ptrs = _ptrs(pad)
    for m, n_after in ((10, 110), (70, 180)):
        xn, yn = rng.uniform(0, 1000, (m, 5)), rng.standard_normal((m, 1))
        assert pad.extend(t(xn), t(yn), bucket=64) is pad
        dense = dense.extend(t(xn), t(yn))
        jpad = jpad.extend(jnp.asarray(xn), jnp.asarray(yn), bucket=64)
        assert pad.n_real == int(jpad.n_real) == n_after
        assert pad.num_padded == 300 and _ptrs(pad) == ptrs
        _same(pad.predict_mean_std(t(xt)), dense.predict_mean_std(t(xt)))
        _same(pad.predict_mean_std(t(xt)),
              jpad.predict_mean_std(jnp.asarray(xt)))
    np.testing.assert_allclose(pad.log_marginal_likelihood(),
                               dense.log_marginal_likelihood(), rtol=1e-9)
    np.testing.assert_allclose(pad.log_marginal_likelihood(),
                               jpad.log_marginal_likelihood(), rtol=1e-9)
    # the bucket-pad rows were rewritten as unit rows
    assert torch.equal(pad.l[180:, 180:], torch.eye(120, dtype=pad.l.dtype))
    xn, yn = rng.uniform(0, 1000, (100, 5)), rng.standard_normal((100, 1))
    out = pad.extend(t(xn), t(yn), bucket=64)      # 128 > 120 slots
    jout = jpad.extend(jnp.asarray(xn), jnp.asarray(yn), bucket=64)
    dense = dense.extend(t(xn), t(yn))
    assert out is not pad and out.n_real is None and jout.n_real is None
    assert out.num_train == jout.num_train == 280
    assert pad.n_real == 180                       # left as it was
    _same(out.predict_mean_std(t(xt)), dense.predict_mean_std(t(xt)))
    _same(out.predict_mean_std(t(xt)), jout.predict_mean_std(jnp.asarray(xt)))


def test_unbucketed_extend_and_strip_padding():
    x, y, xt, rng = _data(seed=7)
    pad = fit_gp(SPEC, t(x[:80]), t(y[:80]), pad_to=100)
    assert pad.extend(t(x[80:]), t(y[80:])) is pad     # exactly fills
    assert pad.num_train == pad.num_padded == 100
    dense = fit_gp(SPEC, t(x[:80]), t(y[:80])).extend(t(x[80:]), t(y[80:]))
    stripped = pad.strip_padding()
    assert stripped.n_real is None and stripped.row_mask is None
    assert stripped.l.data_ptr() != pad.l.data_ptr()
    _same(stripped.predict_mean_std(t(xt)), dense.predict_mean_std(t(xt)))
    assert dense.strip_padding() is dense


@pytest.mark.parametrize("kw,match", [
    ({"pad_to": 50}, "pad_to=50 < n=100"),
    ({"pad_to": 200, "get": "ntk"}, "get='nngp' only"),
    ({"pad_to": TP.EXACT_MAX_N_CPU + 1}, "default_exact_max_n"),
])
def test_padded_fit_guards(kw, match):
    x, y, _, _ = _data()
    with pytest.raises(ValueError, match=match):
        fit_gp(SPEC, t(x), t(y), **kw)


def test_a_failed_schur_factor_leaves_the_padded_posterior_intact():
    """An indefinite Schur complement raises FactorError before anything
    is written: every tensor and n_real as they were."""
    x, y, xt, rng = _data()
    pad = fit_gp(SPEC, t(x), t(y), pad_to=200)
    want = pad.predict_mean_std(t(xt))
    before = {k: getattr(pad, k).clone()
              for k in ("x_train", "y_train", "l", "alpha", "row_mask")}
    good_reg = pad.reg
    pad.reg = torch.tensor(-1e12, dtype=torch.float64)   # K22 - big I
    with pytest.raises(FactorError, match="extend"):
        pad.extend(t(rng.uniform(0, 1000, (5, 5))), torch.zeros(5, 1),
                   bucket=8)
    pad.reg = good_reg
    assert pad.n_real == 100
    for k, v in before.items():
        assert torch.equal(getattr(pad, k), v), k
    _same(pad.predict_mean_std(t(xt)), want, 0.0, 0.0)


def test_the_gram_wrappers_write_into_a_row_block():
    """out=: the real block of a wider matrix, as the padded fit and
    extend write it; the launchers take its row stride and refuse a
    column-strided output before they need the card."""
    from nngp_tpu_torch.ops.gram_cuda import (gram_cross, gram_sym,
                                              launch_cross, launch_sym)

    x, _, xt, _ = _data(n_train=7, n_test=3)
    x, xt = t(x), t(xt)
    big = torch.full((2, 9, 9), float("nan"), dtype=torch.float64)
    gram_sym(SPEC, x, ("nngp", "ntk"), diag_add=0.5,
             out=(big[0, :7, :7], big[1, :7, :7]))
    for got, want in zip(big[:, :7, :7],
                         gram_sym(SPEC, x, ("nngp", "ntk"), diag_add=0.5)):
        assert torch.equal(got, want)
    assert big[:, 7:].isnan().all() and big[:, :7, 7:].isnan().all()
    c = torch.full((3, 9), float("nan"), dtype=torch.float64)
    gram_cross(SPEC, xt, x, out=c[:, :7])
    assert torch.equal(c[:, :7], gram_cross(SPEC, xt, x))
    assert c[:, 7:].isnan().all()
    with pytest.raises(ValueError, match="out= takes"):
        gram_sym(SPEC, x, "ntk", out=big[0, :7, :7])
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch_sym(SPEC, x, big[0, :7, :7])
    with pytest.raises(ValueError, match="contiguous rows"):
        launch_cross(SPEC, xt, x, big[0, :7, :3].mT)


# --------------------------------------------------------- serving layer
def test_bucket_policy():
    assert [graphs.bucket_of(k) for k in (1, 64, 65, 200, 8192)] == \
        [64, 64, 128, 256, 8192]
    assert graphs.buckets_upto(300) == [64, 128, 256]
    assert graphs.buckets_upto(4096, largest=512) == [64, 128, 256, 512]
    assert graphs.buckets_upto(32) == []


def test_buckets_chunk_above_the_largest_and_tile_the_last_row(
        monkeypatch):
    """On the CPU the buckets run eagerly: a 300-row batch with a largest
    bucket of 128 runs as 128 + 128 + 44 (padded to 64 with its last
    row), each bucket once, and gives the direct predict's values."""
    x, y, xt, rng = _data()
    post = fit_gp(SPEC, t(x), t(y))
    rows = rng.uniform(0, 1000, (300, 5))
    bg = graphs.BucketGraphs(post)
    assert bg.largest == graphs.BUCKET_MAX == 8192
    bg.largest = 128
    seen = []
    orig = post.predict_mean_std

    def spy(xb):
        seen.append((xb.shape[0], float(xb[-1, 0])))
        return orig(xb)

    monkeypatch.setattr(post, "predict_mean_std", spy)
    got = bg.predict(rows)
    assert [s[0] for s in seen] == [128, 128, 64]
    assert seen[2][1] == rows[-1, 0]               # the last row tiled
    _same(got, orig(t(rows)), 1e-12, 1e-12)
    assert bg.predict(np.zeros((0, 5)))[0].shape == (0,)
    with pytest.raises(ValueError, match="x must be"):
        bg.predict(rows[:, :4])


def test_pool_estimate_caps_the_largest_bucket():
    x, y, _, _ = _data()
    post = fit_gp(SPEC, t(x), t(y), pad_to=128)
    assert graphs.pool_estimate(post, 64) == 64 * 6 * 128 * 8
    prescaled = fit_gp(SPEC, t(np.float32(x)), t(np.float32(y)),
                       input_scale=2.0)
    assert graphs.pool_estimate(prescaled, 1) == 6 * 100 * 4 + 4 * 100 * 8
    assert graphs.largest_bucket(post) == graphs.BUCKET_MAX    # the CPU


# -------------------------------------------------------------- Estimator
def _est_pair(toy, **kw):
    stats, qdir = toy
    kw.setdefault("dtype", np.float64)
    return (Estimator("toy", None, qdir, stats=stats, verbose=False,
                      device="cpu", **kw),
            JaxEstimator("toy", None, qdir, stats=stats, verbose=False,
                         **kw))


def test_pad_slots_extends_in_place_like_jax_and_the_dense_estimator(toy):
    est, jest = _est_pair(toy, pad_slots=200)
    ref, _ = _est_pair(toy)
    post = est.posterior
    n0 = post.num_train
    assert post.num_padded == n0 + 200 == jest.posterior.num_padded
    ptrs = _ptrs(post)
    est.predict(Q)
    graphs_before = est._graphs
    assert len(est._pred_cache) == len(Q)
    for lines in (FEEDBACK, FEEDBACK[:1]):
        assert est.extend_with_lines(lines) == len(lines)
        jest.extend_with_lines(lines)
        ref.extend_with_lines(lines)
        assert est.posterior is post and _ptrs(post) == ptrs
        assert len(est._pred_cache) == 0          # the memo was emptied
        assert est._graphs is graphs_before       # the buckets kept
        assert post.num_train == int(jest.posterior.n_real)
        _same(est.predict(Q), ref.predict(Q))
        _same(est.predict(Q), jest.predict(Q))
    assert post.num_train == n0 + 4 and post.num_padded == n0 + 200
    np.testing.assert_allclose(post.log_marginal_likelihood(),
                               ref.posterior.log_marginal_likelihood(),
                               rtol=1e-9)


def test_pad_slots_run_out_into_the_dense_fallback(toy):
    """4 slots: a 3-line batch takes a 64-row bucket, which does not fit,
    so the posterior becomes dense and the buckets are dropped."""
    est, jest = _est_pair(toy, pad_slots=4)
    ref, _ = _est_pair(toy)
    est.predict(Q)
    old = est.posterior
    est.extend_with_lines(FEEDBACK)
    jest.extend_with_lines(FEEDBACK)
    ref.extend_with_lines(FEEDBACK)
    assert est.posterior is not old and est.posterior.n_real is None
    assert jest.posterior.n_real is None and est._graphs is None
    assert est.posterior.num_train == jest.posterior.num_train == 63
    _same(est.predict(Q), ref.predict(Q))
    _same(est.predict(Q), jest.predict(Q))


def test_a_failed_padded_extend_keeps_the_estimator_serving(toy):
    est, _ = _est_pair(toy, pad_slots=64)
    want = est.predict(Q)
    good = est.posterior.reg
    est.posterior.reg = torch.tensor(-1e12, dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="extend"):
        est.extend_with_lines(FEEDBACK)
    est.posterior.reg = good
    assert est.posterior.num_train == 60
    _same(est.predict(Q), want, 0.0, 0.0)


@pytest.mark.parametrize("kw", [
    {"nystrom_m": 32}, {"kernel_type": "ntk"},
    {"tier": "nystrom"}, {"tier": "auto", "exact_max_n": 10},
], ids=["nystrom_m", "ntk", "tier-nystrom", "auto-routed"])
def test_pad_slots_guards(toy, kw):
    stats, qdir = toy
    with pytest.raises(ValueError, match="pad_slots"):
        Estimator("toy", None, qdir, stats=stats, verbose=False,
                  device="cpu", pad_slots=100, **kw)
    if "exact_max_n" not in kw:
        with pytest.raises(ValueError, match="pad_slots"):
            JaxEstimator("toy", None, qdir, stats=stats, verbose=False,
                         pad_slots=100, **kw)


def test_warmup_returns_the_buckets_like_jax(toy):
    est, jest = _est_pair(toy, pad_slots=16)
    lines = Q[:1]
    want = est.predict(lines)
    post, memo = est.posterior, dict(est._pred_cache)
    seen = []
    orig = est._bucketed_predict

    def spy(x):
        seen.append(x.shape[0])
        return orig(x)

    est._bucketed_predict = spy
    buckets = est.warmup(max_batch=256, verbose=False)
    del est._bucketed_predict
    assert buckets == jest.warmup(max_batch=256, verbose=False) \
        == seen == [64, 128, 256]
    assert est.posterior is post and dict(est._pred_cache) == memo
    assert est.drift_monitor is None
    _same(est.predict(lines), want, 1e-12, 1e-12)


def test_padded_checkpoints_travel_both_ways(toy, tmp_path):
    """A padded JAX checkpoint restores padded in the port (not cut to its
    real rows) and keeps extending into its slots like JAX's restore;
    the port's padded checkpoint restores padded in JAX."""
    est, jest = _est_pair(toy, pad_slots=100)
    for e in (est, jest):
        e.extend_with_lines(FEEDBACK)
    est.save(str(tmp_path / "port"))
    jest.save(str(tmp_path / "jax"))
    for side in ("port", "jax"):
        with open(tmp_path / side / "meta.json") as f:
            assert json.load(f)["n_real"] == 63
    back = Estimator.restore(str(tmp_path / "jax"), device="cpu")
    jback = JaxEstimator.restore(str(tmp_path / "port"))
    assert back.posterior.n_real == int(jback.posterior.n_real) == 63
    assert back.posterior.num_padded == jback.posterior.num_padded == 160
    _same(back.predict(Q), jest.predict(Q))
    _same(jback.predict(Q), est.predict(Q))
    ptrs = _ptrs(back.posterior)
    for e in (back, jback, est):
        e.extend_with_lines(FEEDBACK[:2])
    assert back.posterior.num_train == 65 and _ptrs(back.posterior) == ptrs
    _same(back.predict(Q), jback.predict(Q))
    _same(back.predict(Q), est.predict(Q), 1e-12, 1e-12)
    back.relearn_hyperparams(steps=3, verbose=False)   # the real rows only
    assert back.posterior.num_train == 65 and back.posterior.n_real is None


# ---------------------------------------------------------- ActiveLearner
def _split(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1000, (300, 6))
    y = x[:, :2].sum(1, keepdims=True) / 300.0 + rng.normal(0, 0.3, (300, 1))
    return x[:30], y[:30], x[30:240], y[30:240], x[240:], y[240:]


@pytest.mark.parametrize("refit", ["incremental", "full"])
def test_pad_acquisitions_rounds_match_dense_and_jax(refit):
    common = dict(budget=40, active_iters=3, biased_sample=False,
                  refit=refit, seed=11)
    dense = ActiveLearner(SPEC, device="cpu", **common)
    padded = ActiveLearner(SPEC, device="cpu", pad_acquisitions=True,
                           **common)
    jpadded = JaxLearner(jax_spec(SPEC), pad_acquisitions=True, **common)
    split = _split()
    post_d, hist_d = dense.active_train(*split, printer=None)
    post_p, hist_p = padded.active_train(*split, printer=None)
    jpost, jhist = jpadded.active_train(*split, printer=None)
    assert post_p.num_padded == int(jpost.num_padded) == 30 + 3 * 40
    assert post_p.num_train == post_d.num_train == jpost.num_train == 150
    for h in (hist_d, jhist):
        assert [a["num_train"] for a in hist_p] == [a["num_train"]
                                                    for a in h]
        np.testing.assert_allclose([a["val_mse"] for a in hist_p],
                                   [a["val_mse"] for a in h], rtol=1e-9)
    _same(post_p.predict_mean_std(t(split[4])),
          post_d.predict_mean_std(t(split[4])))


@pytest.mark.parametrize("kw", [{"nystrom_m": 32}, {"kernel_type": "ntk"}],
                         ids=["nystrom_m", "ntk"])
def test_pad_acquisitions_guards(kw):
    with pytest.raises(ValueError, match="pad_acquisitions"):
        ActiveLearner(SPEC, pad_acquisitions=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="pad_acquisitions"):
        JaxLearner(jax_spec(SPEC), pad_acquisitions=True, **kw)


# ------------------------------------------------------------------ CLIs
def test_active_train_pad_acquisitions_matches_the_jax_cli(capsys):
    from nngp_tpu.cli import active_train as jax_cli
    from nngp_tpu_torch.cli import active_train
    from tests.test_torch_active_cli import SYNTH

    argv = ["--x64", "--schema_name", "synth", "--query_path", SYNTH,
            "--budget", "60", "--active_iters", "2", "--selection", "topk",
            "--pad_acquisitions"]
    want = jax_cli.main(argv)
    got = active_train.main(["--device", "cpu", *argv])
    capsys.readouterr()
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)


def test_serve_demo_pad_slots_matches_the_jax_cli(toy, tmp_path, capsys):
    """--pad_slots: both demos fit a padded posterior (its checkpoint's
    n_real and padded rows) and print the same estimates within 1e-3:
    the demos run in fp32, and the port's fp32 variance runs in fp64
    where JAX's runs in fp32 (the synth encoding's input prescale,
    `gp.posterior.raw_fp64`)."""
    from nngp_tpu.cli import serve_demo as jax_demo
    from nngp_tpu_torch.cli import serve_demo

    stats, qdir = toy
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    for i, s in enumerate(stats):
        s.save(str(stats_dir / f"{i}_{s.table_name}.json"))
    test_file = tmp_path / "test.txt"
    test_file.write_text("\n".join(FEEDBACK) + "\n")   # cards stripped
    outs = {}
    for name, main, extra in (("jax", jax_demo.main, []),
                              ("port", serve_demo.main,
                               ["--device", "cpu"])):
        main(extra + ["--schema_name", "toy", "--stats_dir",
                      str(stats_dir), "--train_query_path", qdir,
                      "--test_query_file", str(test_file), "--ckpt",
                      str(tmp_path / name), "--pad_slots", "16"])
        out = capsys.readouterr().out
        assert "predicted 3 queries" in out
        outs[name] = np.asarray([l.split()[:2] for l in out.split(
            "first 5")[1].split("\n")[1:4]], float)
        with open(tmp_path / name / "meta.json") as f:
            assert json.load(f)["n_real"] == 60
        with np.load(tmp_path / name / "posterior.npz") as z:
            assert z["x_train"].shape[0] == 76
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-3)


@pytest.mark.parametrize("main,argv", [
    ("serve_demo", ["--schema_name", "toy", "--train_query_path", "q",
                    "--test_query_file", "t", "--pad_slots", "8",
                    "--tier", "nystrom"]),
    ("active_train", ["--pad_acquisitions", "--kernel_type", "ntk"]),
], ids=["serve_demo", "active_train"])
def test_cli_padding_flags_refuse_other_tiers(main, argv, capsys):
    import importlib

    cli = importlib.import_module(f"nngp_tpu_torch.cli.{main}")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert "single-device exact" in capsys.readouterr().err
