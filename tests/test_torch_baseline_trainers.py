"""The baseline trainers of the port (`baselines/trainer.py`,
`baselines/mscn_trainer.py`, `active/baseline_learner.py`) and the copied
MSCN featurizer against the JAX package.

Step for step: the JAX trainers take their minibatch order from
`np.random.default_rng(seed)` and their init from `PRNGKey(seed)`, so the
JAX init carried across by `nngp_tpu_torch.convert` and the same seed put
both packages on the same trajectory. After 2-3 epochs of fp32 training at
n ~ 300 every trained parameter of the six dropout-free trainers agrees with
JAX's within rtol 2e-4 of the leaf's largest magnitude (fp32 rounding
through ~15 Adam steps; what was found is ~1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.active.baseline_learner import \
    BaselineActiveLearner as JaxLearner
from nngp_tpu.baselines import mscn_trainer as JMT
from nngp_tpu.baselines import trainer as JTR
from nngp_tpu.featurize import mscn as JF
from nngp_tpu.models import baselines_flax as JB
from nngp_tpu.models import mscn as JM
from nngp_tpu.models import tree_lstm as JT
from nngp_tpu_torch import convert as C
from nngp_tpu_torch.active import BaselineActiveLearner
from nngp_tpu_torch.baselines import mscn_trainer as TMT
from nngp_tpu_torch.baselines import trainer as TTR
from nngp_tpu_torch.featurize import mscn as TF
from tests.test_torch_common import n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")
SYNTH = os.path.join(REPO, "workloads", "synth_join_data")
SYNTH_STATS = os.path.join(REPO, "workloads", "synth_stats")
TRAIN_RTOL = 2e-4


def _task(rows=300, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (rows, d)).astype(np.float32)
    y = (3 * x[:, :1] + x[:, 1:2] ** 2 + 0.02 * rng.standard_normal((rows, 1)))
    return x, (y * 10).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_params(state, want, rtol=TRAIN_RTOL):
    """Every leaf within rtol of its largest magnitude."""
    assert set(state) == set(want)
    worst = 0.0
    for k, w in want.items():
        w = n(w)
        err = np.abs(n(state[k]) - w).max() / max(np.abs(w).max(), 1e-12)
        worst = max(worst, err)
        assert err <= rtol, (k, err)
    return worst


def _moved(state, init):
    return any(not np.allclose(n(state[k]), n(init[k]), atol=1e-4)
               for k in init)


# ------------------------------------------------------------ step for step
def _standardized(x):
    x = jnp.asarray(x, jnp.float32)
    return (x - jnp.mean(x, axis=0)) / (jnp.std(x, axis=0) + 1e-6)


KW = dict(num_hid=16, epochs=2, batch_size=64, seed=3)


def test_train_multitask_step_for_step_across_an_lr_boundary():
    """decay_patience 1: the staircase drops the LR at the start of the
    second and third epoch (every ceil(300 / 64) = 5 steps)."""
    x, y = _task()
    kw = dict(KW, epochs=3, decay_patience=1, decay_factor=0.5,
              max_classes=6, coeff=0.7)
    jinit = JB.MultiTaskMLP(hid_ch=16, cla_out_ch=6).init(
        jax.random.PRNGKey(3), _standardized(x)[:1])
    init = C.multitask_state(_np(jinit))
    lines, jlines = [], []
    jmodel, jparams = JTR.train_multitask(x, y, verbose=jlines.append, **kw)
    model = TTR.train_multitask(x, y, device="cpu", init=init,
                                verbose=lines.append, **kw)
    _same_params(model.model.state_dict(), C.multitask_state(_np(jparams)))
    assert _moved(model.model.state_dict(), init)
    np.testing.assert_allclose(n(model.loc), n(jmodel.loc), rtol=1e-6)
    np.testing.assert_allclose(n(model.scale), n(jmodel.scale), rtol=1e-6)
    # the per-epoch loss lines, and the wrapped models on raw features
    assert [l.split("=")[0] for l in lines] == \
        [l.split("=")[0] for l in jlines]
    np.testing.assert_allclose([float(l.split("=")[1]) for l in lines],
                               [float(l.split("=")[1]) for l in jlines],
                               rtol=1e-4)
    with torch.no_grad():
        reg, logp = model(x)
    jreg, jlogp = jmodel.apply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(n(reg), n(jreg), rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(logp), n(jlogp), rtol=0, atol=1e-3)
    # without the boundary the trajectory is another
    flat = TTR.train_multitask(x, y, device="cpu", init=init,
                               **dict(kw, decay_patience=10))
    assert _moved(flat.model.state_dict(), model.model.state_dict())


def test_train_density_step_for_step():
    x, y = _task(seed=1)
    jinit = JB.MLPDensityRegressor(hid_ch=16).init(jax.random.PRNGKey(3),
                                                   _standardized(x)[:1])
    _, jparams = JTR.train_density(x, y, **KW)
    model = TTR.train_density(x, y, device="cpu",
                              init=C.density_state(_np(jinit)), **KW)
    _same_params(model.model.state_dict(), C.density_state(_np(jparams)))
    # standardize=False trains on the raw features
    _, jraw = JTR.train_density(x, y, standardize=False, **KW)
    raw = TTR.train_density(x, y, device="cpu", standardize=False,
                            init=C.density_state(_np(jinit)), **KW)
    _same_params(raw.model.state_dict(), C.density_state(_np(jraw)))
    assert not n(raw.loc).any() and (n(raw.scale) == 1).all()


def test_train_deep_ensemble_step_for_step():
    x, y = _task(seed=2)
    y = y / 5.0
    jinit = JB.DeepEnsemble(num_models=3, hid_ch=16).init(
        jax.random.PRNGKey(3), _standardized(x)[:1])
    _, jparams = JTR.train_deep_ensemble(x, y, num_models=3, **KW)
    ens = TTR.train_deep_ensemble(x, y, num_models=3, device="cpu",
                                  init=C.deep_ensemble_state(_np(jinit)),
                                  **KW)
    _same_params(ens.model.state_dict(),
                 C.deep_ensemble_state(_np(jparams)))


@pytest.fixture(scope="module")
def forest_sets():
    """300 forest queries as padded MSCN predicate sets, from both
    packages' encoders."""
    from nngp_tpu.data.workload import single_table_stats as jstats
    from nngp_tpu.featurize.parser import load_single_table_queries as jload
    from nngp_tpu_torch.data.workload import single_table_stats
    from nngp_tpu_torch.featurize.parser import load_single_table_queries

    stats = single_table_stats("forest", "forest", FOREST)
    queries, cards, _ = load_single_table_queries(FOREST, stats)
    js = jstats("forest", "forest", FOREST, None)
    jqueries, _, _ = jload(FOREST, js)
    batch, mask = TF.MSCNSingleEncoder(stats).encode_batch(queries[:300])
    jbatch, jmask = JF.MSCNSingleEncoder(js).encode_batch(jqueries[:300])
    y = np.log2(np.asarray(cards[:300], np.float64)).reshape(-1, 1)
    return batch, mask, jbatch, jmask, y


@pytest.fixture(scope="module")
def synth_sets():
    """300 synth_join queries through both packages' multi-join MSCN
    encoders: the padded table / pred / join sets and the plan chains."""
    from nngp_tpu.featurize.stats import load_stats_dir as jload
    from nngp_tpu_torch.featurize.stats import load_stats_dir

    enc = TF.MSCNMultiEncoder(load_stats_dir(SYNTH_STATS), seed=10)
    jenc = JF.MSCNMultiEncoder(jload(SYNTH_STATS), seed=10)
    queries, cards, _ = enc.load_queries(SYNTH)
    jqueries, jcards, _ = jenc.load_queries(SYNTH)
    assert cards == jcards
    pick = slice(0, None, len(queries) // 300)    # every join size
    y = np.log2(np.asarray(cards[pick], np.float64)).reshape(-1, 1)[:300]
    queries, jqueries = queries[pick][:300], jqueries[pick][:300]
    sets = enc.encode_batch(queries)
    jsets = jenc.encode_batch(jqueries)
    roots = [enc.encode_plan(*q) for q in queries]
    jroots = [jenc.encode_plan(*q) for q in jqueries]
    return sets, jsets, roots, jroots, y


def test_mscn_featurizer_copy_is_bit_for_bit(forest_sets, synth_sets):
    batch, mask, jbatch, jmask, _ = forest_sets
    assert batch.shape[0] == 300 and batch.shape == jbatch.shape
    np.testing.assert_array_equal(batch, jbatch)
    np.testing.assert_array_equal(mask, jmask)
    sets, jsets, roots, jroots, _ = synth_sets
    for (a, am), (b, bm) in zip(sets, jsets):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(am, bm)
    arrays = TMT.plans_to_arrays(roots)
    jarrays = JMT.plans_to_arrays(jroots)
    assert len(arrays) == len(jarrays) == 9
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert arrays[6].any() and not arrays[6].all()   # chains of mixed length
    assert TF.JOIN_OPS == JF.JOIN_OPS
    padded, pmask = TF.pad_sets([np.zeros((0, 3)), np.ones((2, 3))], feat=3)
    assert padded.shape == (2, 2, 3) and pmask.tolist() == [[False, False],
                                                            [True, True]]


MKW = dict(epochs=2, batch_size=64, seed=3)


def test_train_mscn_single_step_for_step(forest_sets):
    batch, _, _, _, y = forest_sets
    kw = dict(pred_hid_ch=16, pred_out_ch=16, mlp_hid_ch=16)
    jinit = JM.MSCN(**kw).init(jax.random.PRNGKey(3),
                               jnp.asarray(batch[:1], jnp.float32))
    _, jparams = JMT.train_mscn_single(batch, y, **MKW, **kw)
    init = C.mscn_state(_np(jinit))
    model = TMT.train_mscn_single(batch, y, device="cpu", init=init, **MKW,
                                  **kw)
    _same_params(model.state_dict(), C.mscn_state(_np(jparams)))
    assert _moved(model.state_dict(), init)


def test_train_mscn_multi_and_join_step_for_step(synth_sets):
    ((t, _), (p, _), (j, _)), _, _, _, y = synth_sets
    kw = dict(table_hid_ch=8, table_out_ch=8, pred_hid_ch=16, pred_out_ch=16,
              join_hid_ch=8, join_out_ch=8, mlp_hid_ch=16)
    first = [jnp.asarray(a[:1], jnp.float32) for a in (t, p, j)]
    jinit = JM.MSCNMultiJoin(**kw).init(jax.random.PRNGKey(3), *first)
    _, jparams = JMT.train_mscn_multi(t, p, j, y, **MKW, **kw)
    model = TMT.train_mscn_multi(t, p, j, y, device="cpu",
                                 init=C.mscn_multi_state(_np(jinit)), **MKW,
                                 **kw)
    _same_params(model.state_dict(), C.mscn_multi_state(_np(jparams)))
    # the binary-join model on the same sets (left = right = pred sets)
    kw = dict(pred_hid_ch=16, pred_out_ch=16, join_hid_ch=8, join_out_ch=8,
              mlp_hid_ch=16)
    jinit = JM.MSCNJoin(**kw).init(jax.random.PRNGKey(3), first[1], first[1],
                                   first[2])
    _, jparams = JMT.train_mscn_join(p, p, j, y, **MKW, **kw)
    model = TMT.train_mscn_join(p, p, j, y, device="cpu",
                                init=C.mscn_join_state(_np(jinit)), **MKW,
                                **kw)
    _same_params(model.state_dict(), C.mscn_join_state(_np(jparams)))


def test_train_tree_lstm_step_for_step(synth_sets):
    """The port's cell has one bias and no recurrent kernels; the flax
    leaves with no counterpart multiply the zero state and only decay."""
    _, _, roots, jroots, y = synth_sets
    kw = dict(op_out_ch=8, meta_out_ch=8, pred_hid_ch=16, pred_out_ch=16,
              lstm_hid_ch=16, mlp_hid_ch=16)
    jarrays = JMT.plans_to_arrays(jroots)
    jinit = JT.TreeLSTMMultiJoin(**kw).init(
        jax.random.PRNGKey(3), *(jnp.asarray(a[:1]) for a in jarrays))
    _, jparams, _ = JMT.train_tree_lstm(jroots, y, **MKW, **kw)
    init = C.tree_lstm_multi_state(_np(jinit))
    model, arrays = TMT.train_tree_lstm(roots, y, device="cpu", init=init,
                                        **MKW, **kw)
    _same_params(model.state_dict(), C.tree_lstm_multi_state(_np(jparams)))
    assert _moved(model.state_dict(), init)
    with torch.no_grad():
        out = model(*TMT.to_device(arrays, "cpu"))
    jout = JT.TreeLSTMMultiJoin(**kw).apply(
        jparams, *(jnp.asarray(a) for a in jarrays))
    np.testing.assert_allclose(n(out), n(jout), rtol=0, atol=2e-3)


# ------------------------------------------------- host helpers, as in JAX
def test_magnitude_class_uncertainty_and_epoch_perm_match_jax():
    ys = np.array([0.1, 3.0, 9.97, 33.2, 40.0, -2.0])
    for kw in ({}, {"max_classes": 4}, {"label_base": 2.0}):
        got = TTR.magnitude_class(ys, **kw)
        np.testing.assert_array_equal(got, JTR.magnitude_class(ys, **kw))
        assert got.dtype == np.int32
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(5), size=12))
    reg = rng.uniform(0, 30, 12)
    for kind in ("entropy", "confident", "margin", "consist"):
        np.testing.assert_array_equal(
            TTR.compute_uncertainty(kind, logp, reg),
            JTR.compute_uncertainty(kind, logp, reg))
    np.testing.assert_array_equal(
        TTR.compute_uncertainty("random", logp, reg,
                                np.random.default_rng(5)),
        JTR.compute_uncertainty("random", logp, reg,
                                np.random.default_rng(5)))
    with pytest.raises(ValueError, match="Unsupported uncertainty"):
        TTR.compute_uncertainty("bald", logp, reg)
    for rows, batch in ((300, 64), (128, 64), (10, 4)):
        np.testing.assert_array_equal(
            TTR._epoch_perm(rows, batch, np.random.default_rng(1)),
            JTR._epoch_perm(rows, batch, np.random.default_rng(1)))


# ------------------------------------------------------------------- learns
def test_multitask_trainer_learns():
    x, y = _task(rows=400)
    model = TTR.train_multitask(x, y, num_hid=64, epochs=80, lr=3e-3,
                                batch_size=64, device="cpu")
    with torch.no_grad():
        reg, log_probs = model(x)
    assert float(np.mean((n(reg) - y) ** 2)) < np.var(y)
    np.testing.assert_allclose(np.exp(n(log_probs)).sum(1), 1.0, rtol=1e-4)


def test_density_ensemble_and_mc_dropout_train():
    x, y = _task()
    model = TTR.train_density(x, y, num_hid=32, epochs=15, device="cpu")
    with torch.no_grad():
        _, s = model(x)
    assert bool((s > 0).all())
    ys = y / 5.0
    ens = TTR.train_deep_ensemble(x, ys, num_models=3, num_hid=32, epochs=50,
                                  lr=3e-3, device="cpu")
    mean, std = ens.predict(x)
    assert np.mean((n(mean) - ys.ravel()) ** 2) < np.var(ys)
    assert mean.shape == std.shape == (300,)
    lines = []
    mc = TTR.train_mc_dropout(x, y, num_hid=32, num_samples=8, epochs=10,
                              device="cpu", verbose=lines.append)
    mean, std = mc.predict(x, torch.Generator().manual_seed(0))
    assert bool((std >= 0).all()) and len(lines) == 10
    # plain MSE on the stochastic forward: the loss falls
    first, last = (float(l.split("=")[1]) for l in (lines[0], lines[-1]))
    assert last < first
    again = TTR.train_mc_dropout(x, y, num_hid=32, num_samples=8, epochs=10,
                                 device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        mc.state_dict().values(), again.state_dict().values()))


def test_sklearn_baselines_match_jax_package():
    x, y = _task(rows=200)
    mean, std = TTR.sklearn_gp_train_and_test(x[:120], y[:120], x[120:130])
    jmean, jstd = JTR.sklearn_gp_train_and_test(x[:120], y[:120], x[120:130])
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    np.testing.assert_array_equal(
        TTR.krr_train_and_test(x[:120], y[:120], x[120:]),
        JTR.krr_train_and_test(x[:120], y[:120], x[120:]))
    reg = TTR.train_mlp_regressor(x[:120], y[:120], num_hid=16, epochs=5)
    jreg = JTR.train_mlp_regressor(x[:120], y[:120], num_hid=16, epochs=5)
    np.testing.assert_array_equal(reg.predict(x[120:]), jreg.predict(x[120:]))


def test_xgb_branch_falls_back_to_sklearn_as_the_jax_package_does():
    x, y = _task()
    pred = TTR.xgb_train_and_test(x[:200], y[:200], x[200:])
    np.testing.assert_array_equal(
        pred, JTR.xgb_train_and_test(x[:200], y[:200], x[200:]))
    assert float(np.mean((pred - y[200:].ravel()) ** 2)) < \
        0.5 * float(np.var(y[200:]))
    try:
        import xgboost  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="xgboost is not installed"):
            TTR.xgb_train_and_test(x[:200], y[:200], x[200:],
                                   allow_sklearn_fallback=False)


# ----------------------------------------------------------- active learner
@pytest.mark.parametrize("biased", [True, False], ids=["biased", "topk"])
def test_selection_on_a_given_uncertainty_stream_matches_jax(biased):
    """The numpy selection is copied: the same seed and the same
    uncertainties pick the same pool rows, round after round."""
    kw = dict(budget=25, biased_sample=biased, seed=7)
    learner = BaselineActiveLearner(device="cpu", **kw)
    jlearner = JaxLearner(**kw)
    rng = np.random.default_rng(0)
    for pool in (400, 375, 20):
        unc = rng.random(pool)
        np.testing.assert_array_equal(learner.select(unc),
                                      jlearner.select(unc))
    zero = np.zeros(50)
    np.testing.assert_array_equal(learner.select(zero),
                                  jlearner.select(zero))
    with pytest.raises(ValueError, match="Unsupported model type"):
        BaselineActiveLearner(model_type="GP", device="cpu")


@pytest.mark.parametrize("model_type", ["DNN", "MCDropout", "DeepEnsemble"])
def test_baseline_active_learner_history(model_type):
    x, y = _task(rows=360)
    lines = []
    learner = BaselineActiveLearner(
        model_type=model_type, budget=40, active_iters=2, epochs=8,
        active_epochs=6, num_hid=32, batch_size=64, device="cpu",
        **({"num_samples": 8} if model_type == "MCDropout" else {}))
    model, history = learner.active_train(
        x[:40], y[:40], x[40:300], y[40:300], x[300:], y[300:],
        printer=lines.append)
    assert [h["iter"] for h in history] == [-1, 0, 1]
    assert [h["num_train"] for h in history] == [40, 80, 120]
    assert all(np.isfinite(h["val_mse"]) for h in history)
    assert "Active Iteration 0: Selection 40" in lines
    assert sum(l.startswith("Test MSE Loss:") for l in lines) == 3
    assert learner.test(model, x[300:], y[300:], printer=None) == \
        pytest.approx(history[-1]["val_mse"],
                      rel=0.2 if model_type == "MCDropout" else 1e-6)


def test_deep_ensemble_demo_runs():
    from nngp_tpu_torch.cli import deep_ensemble_demo

    in_std, out_std = deep_ensemble_demo.main(["--device", "cpu",
                                               "--epochs", "60"])
    assert out_std > in_std > 0
