"""The port's active learning (`nngp_tpu_torch.active`) against the JAX
package's, fp64 on the CPU (the CLI: tests/test_torch_active_cli.py).

Top-k and greedy selections must equal JAX's index for index (the merged
train sets are compared element for element, in order), with per-round
validation MSE within rtol 1e-9; learned hyperparameters of a relearn run
within rtol 1e-6. Biased sampling cannot reproduce JAX's PRNG bits, so it
is held to its law: distinct indices in range, single-draw frequencies
within 5 sigma of p, and the uniform fall-back. The JAX fits take the
exact-diagonal path, as in tests/test_torch_estimator.py.
"""

import numpy as np
import pytest
import torch

import nngp_tpu.gp.posterior as JP
from nngp_tpu.active import ActiveLearner as JaxLearner
from nngp_tpu.active import greedy_variance_select as jax_greedy
from nngp_tpu.models.kernel_spec import KernelSpec as JaxSpec
from nngp_tpu.models.kernel_spec import mlp as jax_mlp
from nngp_tpu_torch.active import ActiveLearner, greedy_variance_select
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from tests.test_torch_common import n, rows, t

@pytest.fixture(scope="module", autouse=True)
def jax_exact_diag():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_FUSED_FIT_MIN_N", 16)
        yield


def _split(seed=1):
    """(x_train, y_train, x_pool, y_pool, x_val, y_val): 60 / 200 / 50
    forest-scale rows whose labels depend on three features."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (60, 200, 50):
        x = rows(m, seed=int(rng.integers(1 << 30)), special=False)
        out += [x, x[:, :3].sum(1, keepdims=True) / 300.0
                + rng.normal(0, 0.3, (m, 1))]
    return out


# ---------------------------------------------------------------- greedy
def _pool_covs(get, noise_from_fit, seed=2):
    """The (P, P) pool covariance of a fitted posterior in each package,
    JAX's over the pool zero-padded to a 64-row bucket as its learner
    pads it, and the fantasy noise."""
    x_tr, y_tr, x_pool = _split(seed)[:3]
    x_pool = x_pool[:40]
    spec = KernelSpec(mlp(1))
    post = fit_gp(spec, t(x_tr), t(y_tr), get=get)
    jpost = JP.fit_gp(JaxSpec(jax_mlp(1)), x_tr, y_tr, get=get)
    pad = np.concatenate([x_pool, np.broadcast_to(x_pool[:1], (24, 20))])
    cov = post._predict_scaled(t(x_pool), True)[1]
    jcov = jpost._predict_scaled(pad, True)[1]
    noise = (float(post.reg), float(jpost.reg)) if noise_from_fit else (0.0,
                                                                        0.0)
    return cov, jcov, noise


@pytest.mark.parametrize("get,noise_from_fit", [
    ("nngp", True), ("nngp", False), ("ntk", True)])
def test_greedy_unpadded_matches_jax_padded(get, noise_from_fit):
    """Masked pad rows cannot change the selection: JAX on the padded
    bucket and the port on the exact pool pick the same indices."""
    cov, jcov, (noise, jnoise) = _pool_covs(get, noise_from_fit)
    got = n(greedy_variance_select(cov, 15, noise))
    want = np.asarray(jax_greedy(jcov, 15, jnoise, num_valid=40))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 15 and got.max() < 40
    np.testing.assert_array_equal(
        n(greedy_variance_select(cov, 15, noise, num_valid=30)),
        np.asarray(jax_greedy(jcov, 15, jnoise, num_valid=30)))


def test_greedy_degenerate_pivots_are_no_ops_as_in_jax():
    """An exactly rank-3 covariance with noise 0: after three pivots the
    conditional variances are exactly 0, and every later pivot (the first
    zero, then the next) is a no-op update, in both packages."""
    cov = np.zeros((6, 6))
    cov[np.ix_([0, 2], [0, 2])] = [[4.0, 2.0], [2.0, 1.0]]   # rank 1
    cov[4, 4], cov[5, 5] = 9.0, 0.5
    got = n(greedy_variance_select(t(cov), 6))
    want = np.asarray(jax_greedy(cov, 6))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [4, 0, 5, 1, 2, 3]
    for fn in (greedy_variance_select, jax_greedy):
        with pytest.raises(ValueError, match="cannot select 7"):
            fn(t(cov) if fn is greedy_variance_select else cov, 7)


# --------------------------------------------------------------- learner
def _pair(budget=20, **kw):
    jkw = {k: v for k, v in kw.items() if k != "device"}
    return (JaxLearner(JaxSpec(jax_mlp(1)), budget=budget, active_iters=3,
                       **jkw),
            ActiveLearner(KernelSpec(mlp(1)), budget=budget, active_iters=3,
                          device="cpu", **kw))


def _run_pair(jl, tl, split):
    jlines, lines = [], []
    jpost, jhist = jl.active_train(*split, printer=jlines.append)
    post, hist = tl.active_train(*split, printer=lines.append)
    # the same rows in the same order (ARD-scaled rows differ in the last
    # bits of the learned scale)
    np.testing.assert_allclose(n(post.x_train), np.asarray(jpost.x_train),
                               rtol=1e-12)
    assert [h["num_train"] for h in hist] == [h["num_train"] for h in jhist]
    np.testing.assert_allclose([h["val_mse"] for h in hist],
                               [h["val_mse"] for h in jhist], rtol=1e-9)
    # the same printed lines, up to the digits of the numbers in them
    assert [l.split(":")[0] for l in lines] == \
        [l.split(":")[0] for l in jlines]
    mse = [float(l.split(":")[1]) for l in lines if l.startswith("Test MSE")]
    jmse = [float(l.split(":")[1]) for l in jlines
            if l.startswith("Test MSE")]
    np.testing.assert_allclose(mse, jmse, rtol=1e-9)
    return post, jpost


@pytest.mark.parametrize("selection,refit,get", [
    ("topk", "incremental", "nngp"),
    ("greedy", "incremental", "nngp"),
    ("topk", "full", "ntk"),
    ("greedy", "full", "ntk"),
])
def test_learner_matches_jax(selection, refit, get):
    jl, tl = _pair(selection=selection, refit=refit, kernel_type=get)
    _run_pair(jl, tl, _split())


def test_chunked_pool_and_greedy_prefilter_match_jax(monkeypatch):
    """Above CHUNKED_POOL_MIN the pool std is predicted in chunks, and
    above GREEDY_POOL_MAX greedy works on the top-std slice of twice the
    budget: both thresholds lowered under the 200-row pool."""
    for cls in (JaxLearner, ActiveLearner):
        monkeypatch.setattr(cls, "CHUNKED_POOL_MIN", 64)
        monkeypatch.setattr(cls, "GREEDY_POOL_MAX", 32)
    for selection in ("greedy", "topk"):
        jl, tl = _pair(selection=selection)
        _run_pair(jl, tl, _split(seed=3))


def test_ard_relearn_matches_jax():
    """relearn_hyper=True with ARD: a cold multi-start learn on the first
    split, then a warm relearn and refit every round, the learned scale
    applied to every input by the learner."""
    kw = dict(selection="topk", relearn_hyper=True, hyper_ard=True,
              hyper_points=48, hyper_warm_steps=5)
    jl, tl = _pair(**kw)
    _run_pair(jl, tl, _split(seed=4))
    for field in ("w", "b", "diag_reg"):
        np.testing.assert_allclose(getattr(tl._hyper, field),
                                   getattr(jl._hyper, field), rtol=1e-6)
    np.testing.assert_allclose(tl._hyper.feature_scale,
                               jl._hyper.feature_scale, rtol=1e-6)
    assert tl.spec == tl._hyper.spec and tl.input_scale == 1.0


def test_merge_and_test_match_jax():
    x_tr, y_tr, x_pool, y_pool, x_val, y_val = _split(seed=5)
    sel = np.array([7, 3, 150, 0])
    got = ActiveLearner.merge_data(torch.tensor(sel), t(x_tr), t(y_tr),
                                   t(x_pool), t(y_pool))
    want = JaxLearner.merge_data(sel, x_tr, y_tr, x_pool, y_pool)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    jl, tl = _pair(selection="topk")
    post = tl.train(x_tr, y_tr)
    jpost = jl.train(x_tr, y_tr)
    lines, jlines = [], []
    mse = tl.test(post, x_val, y_val, printer=lines.append)
    jmse = jl.test(jpost, x_val, y_val, printer=jlines.append)
    assert mse == pytest.approx(jmse, rel=1e-9)
    assert lines[0].startswith("Test MSE Loss:")
    assert len(lines) == len(jlines)
    assert tl.select(post, x_pool[:0]).shape == (0,)
    np.testing.assert_array_equal(n(tl.select(post, x_pool)),
                                  np.asarray(jl.select(jpost, x_pool)))


class _FlatPosterior:
    """A posterior stub whose pool std is `std` and mean 1."""

    def __init__(self, std):
        self.std = torch.as_tensor(std, dtype=torch.float64)

    def predict_mean_std(self, x):
        return torch.ones(x.shape[0], 1, dtype=torch.float64), self.std


@pytest.mark.parametrize("std", [[0.1, 0.4, 0.2, 0.8, 0.5],
                                 [0.0, 0.0, 0.0, 0.0, 0.0]],
                         ids=["p-from-std", "all-zero-uniform"])
def test_biased_single_draws_follow_p(std):
    """4,000 one-point draws: each index's frequency within 5 sigma of
    p = std / sum(std), or of 1/5 when every std is 0."""
    learner = ActiveLearner(KernelSpec(mlp(1)), budget=1, device="cpu")
    post, x_pool = _FlatPosterior(std), torch.zeros(5, 20,
                                                    dtype=torch.float64)
    draws = np.array([int(learner.select(post, x_pool)[0])
                      for _ in range(4000)])
    std = np.asarray(std)
    p = std / std.sum() if std.sum() > 0 else np.full(5, 0.2)
    freq = np.bincount(draws, minlength=5) / draws.size
    sigma = np.sqrt(p * (1 - p) / draws.size)
    assert np.all(np.abs(freq - p) <= 5 * sigma + 1e-12), (freq, p)


def test_biased_batches_are_distinct_in_range_and_seeded():
    x_tr, y_tr, x_pool = _split(seed=6)[:3]
    picks = []
    for seed in (10, 10, 11):
        learner = ActiveLearner(KernelSpec(mlp(1)), budget=30, seed=seed,
                                device="cpu")
        post = learner.train(x_tr, y_tr)
        sel = n(learner.select(post, x_pool))
        assert len(set(sel.tolist())) == 30
        assert sel.min() >= 0 and sel.max() < 200
        picks.append(sel)
    np.testing.assert_array_equal(picks[0], picks[1])
    assert not np.array_equal(picks[0], picks[2])


@pytest.mark.parametrize("kw,rtol", [
    ({"nystrom_m": 32}, 1e-9),
    ({"nystrom_m": 32, "nystrom_grow": 8}, 1e-9),
    ({"nystrom_m": 32, "nystrom_moments": "df64"}, 1e-3),
], ids=["m", "grow", "df64"])
def test_nystrom_arguments_run_the_nystrom_tier(kw, rtol):
    """The Nystrom arguments (once refused, now ported) against the JAX
    learner, top-k: nystrom_m rounds extend the moments, nystrom_grow
    grows the inducing set by 8 rows a round, both to the same validation
    MSE (rtol 1e-9). moments='df64' on fp32 rows is held to JAX's fp64
    pipeline on the same rows at rtol 1e-3 (the fp32 predict and the
    1e-12 rank cut, where fp64 cuts at 1e-14)."""
    split = _split(seed=3)
    jkw = dict(kw)
    if "nystrom_moments" in kw:
        split = [a.astype(np.float32) for a in split]
        jkw.pop("nystrom_moments")
    jl = JaxLearner(JaxSpec(jax_mlp(1)), budget=20, active_iters=3,
                    biased_sample=False, **jkw)
    tl = ActiveLearner(KernelSpec(mlp(1)), budget=20, active_iters=3,
                       selection="topk", device="cpu", **kw)
    jpost, jhist = jl.active_train(*[np.asarray(a, np.float64)
                                     for a in split], printer=None)
    post, hist = tl.active_train(*split, printer=None)
    assert post.num_inducing == jpost.num_inducing == \
        32 + 3 * kw.get("nystrom_grow", 0)
    assert post.moments == kw.get("nystrom_moments", "fp32")
    assert [h["num_train"] for h in hist] == [h["num_train"] for h in jhist]
    np.testing.assert_allclose([h["val_mse"] for h in hist],
                               [h["val_mse"] for h in jhist], rtol=rtol)


class _CudaMesh:
    device_type = "cuda"


@pytest.mark.parametrize("kw,err,match", [
    ({"mesh": _CudaMesh()}, ValueError, "mesh is a cuda mesh"),
    ({"dist_block_size": 64}, ValueError, "needs mesh="),
    ({"pad_acquisitions": True, "nystrom_m": 8}, ValueError,
     "pad_acquisitions is the single-chip exact-nngp"),
])
def test_unported_arguments_name_their_roadmap_item(kw, err, match):
    """The mesh arguments are ported (tests/test_torch_parallel_learn.py)
    and checked: a mesh of another device type, or a panel width without
    a mesh, raise; pad_acquisitions is ported (tests/test_torch_padded.py)
    and refuses the Nystrom tier as the JAX learner does."""
    with pytest.raises(err, match=match):
        ActiveLearner(KernelSpec(mlp(1)), device="cpu", **kw)


def test_bad_arguments_raise():
    for kw, match in (({"refit": "sometimes"}, "refit must be"),
                      ({"selection": "random"}, "selection must be"),
                      ({"nystrom_grow": 8}, "requires nystrom_m"),
                      ({"nystrom_m": 8, "nystrom_grow": 8, "refit": "full"},
                       "refit='incremental'"),
                      ({"nystrom_m": 8, "nystrom_grow": 8,
                        "relearn_hyper": True}, "incompatible"),
                      ({"nystrom_moments": "bf16"}, "nystrom_moments")):
        with pytest.raises(ValueError, match=match):
            ActiveLearner(KernelSpec(mlp(1)), device="cpu", **kw)
    with pytest.raises(TypeError, match="device"):
        ActiveLearner(KernelSpec(mlp(1)))
