"""The port's serving Estimator (`nngp_tpu_torch.serve.estimator`) against
the JAX package's, on the toy two-table schema of
`tests/test_active_serve.py`, fp64 on the CPU.

The JAX fits take the exact-diagonal path (`_FUSED_FIT_MIN_N` lowered), as
the port always does (see tests/test_torch_posterior.py). Tolerances:
predictions rtol 1e-9 in fp64 (the two fits factor the same Gram in two
orders); 1e-4 in fp32. A checkpoint restored in the same package predicts
bit for bit what it saved.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.posterior as JP
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.models.kernel_spec import KernelSpec
from nngp_tpu_torch.ops import gram_cuda
from nngp_tpu_torch.serve import Estimator
from tests.test_active_serve import _toy_schema_files

LINES = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id",
         "ta,tb@x,1.0,-2.0@@ta,tb,id", "ta,tb@x,9.5,0.5@@ta,tb,id",
         "ta,tb@x,5.0,-5.0@@ta,tb,id"]          # the last repeats the first


def _labeled(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        card = max(1, int(scale * 1000 * (xu - xl)))
        out.append(f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id@{card}")
    return out


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="module", autouse=True)
def jax_exact_diag():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_FUSED_FIT_MIN_N", 16)
        yield


def _pair(toy, **kw):
    stats, qdir = toy
    kw.setdefault("dtype", np.float64)
    jest = JaxEstimator("toy", None, qdir, stats=stats, verbose=False, **kw)
    if kw.get("quality") == "best":
        kw.setdefault("learn_hyper", False)
    est = Estimator("toy", None, qdir, stats=stats, verbose=False,
                    device="cpu", **kw)
    return jest, est


@pytest.fixture(scope="module")
def pair64(toy):
    return _pair(toy)


def _close(got, want, rtol=1e-9):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w))))


@pytest.mark.parametrize("kw,rtol", [
    ({}, 1e-9),
    ({"kernel_type": "ntk"}, 1e-9),
    ({"chunk_norm": True, "diag_reg": 1e-2}, 1e-9),
    ({"dtype": np.float32}, 1e-4),
], ids=["nngp", "ntk", "chunk_norm", "fp32"])
def test_predict_matches_jax_estimator(toy, kw, rtol):
    jest, est = _pair(toy, **kw)
    assert est.posterior.num_train == jest.posterior.num_train == 60
    assert est.encoder_kind == "native"
    mean, std = est.predict(LINES)
    assert mean.dtype == np.dtype(kw.get("dtype", np.float64))
    assert mean[0] == mean[4] and std[0] == std[4]
    _close((mean, std), jest.predict(LINES), rtol)


def test_aux_feedback_lines_follow_the_thresholds(tmp_path):
    """use_aux ingests join_query_aux.txt lines whose q-error or coef-var
    reaches its threshold, as the JAX estimator does."""
    stats, qdir = _toy_schema_files(tmp_path)
    with open(os.path.join(qdir, "join_query_aux.txt"), "w") as f:
        f.write("ta,tb@x,1.0,0.0@@ta,tb,id@500@200.0@0.1\n")   # kept
        f.write("ta,tb@x,2.0,0.0@@ta,tb,id@900@1.0@0.0\n")     # dropped
        f.write("ta,tb@x,3.0,0.0@@ta,tb,id@700@1.0@5.0\n")     # kept
    for use_aux, n in ((True, 62), (False, 60)):
        jest = JaxEstimator("toy", None, qdir, stats=stats, use_aux=use_aux,
                            dtype=np.float64, verbose=False)
        est = Estimator("toy", None, qdir, stats=stats, use_aux=use_aux,
                        dtype=np.float64, verbose=False, device="cpu")
        assert est.posterior.num_train == jest.posterior.num_train == n
        _close(est.predict(LINES), jest.predict(LINES))


def test_checkpoint_from_jax_restores_in_the_port(toy, pair64, tmp_path):
    jest, _ = pair64
    jest.calibrate_uncertainty(_labeled(3, 25), verbose=False)
    jest.save(str(tmp_path / "ck"))
    est = Estimator.restore(str(tmp_path / "ck"), device="cpu")
    assert est.std_scale == jest.std_scale
    np.testing.assert_array_equal(est._conformal_scores,
                                  jest._conformal_scores)
    _close(est.predict(LINES), jest.predict(LINES))
    _close(est.predict_interval(LINES, alpha=0.2),
           jest.predict_interval(LINES, alpha=0.2))


def test_checkpoint_from_the_port_restores_in_jax(toy, tmp_path):
    stats, qdir = toy
    est = Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                    kernel_type="ntk", verbose=False, device="cpu")
    est.calibrate_uncertainty(_labeled(4, 25), verbose=False)
    est.save(str(tmp_path / "ck"))
    jest = JaxEstimator.restore(str(tmp_path / "ck"))
    assert jest.kernel_type == "ntk" and jest.std_scale == est.std_scale
    _close(jest.predict(LINES), est.predict(LINES))
    back = Estimator.restore(str(tmp_path / "ck"), device="cpu")
    for got, want in zip(back.predict(LINES), est.predict(LINES)):
        np.testing.assert_array_equal(got, want)


def test_padded_and_column_block_jax_checkpoints_restore(toy, tmp_path):
    """A padded JAX posterior (pad_slots, meta n_real) stays padded, its 8
    slots kept: the posterior extends 3 rows into them in place, and a
    feedback batch (a 64-row bucket) falls back to the dense extend, as in
    the JAX estimator; a column-block factor (meta l_block_starts) is
    assembled into one dense factor. Both predict what the JAX estimator
    predicts."""
    stats, qdir = toy
    jest = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        pad_slots=8, verbose=False)
    jest.save(str(tmp_path / "pad"))
    with open(tmp_path / "pad" / "meta.json") as f:
        assert json.load(f)["n_real"] == 60
    est = Estimator.restore(str(tmp_path / "pad"), device="cpu")
    assert est.posterior.num_train == 60
    assert est.posterior.num_padded == 68
    _close(est.predict(LINES), jest.predict(LINES))
    x = est.encode_lines(LINES[:3])
    y = np.ones((3, 1))
    post = est.posterior
    assert post.extend(x, y) is post and post.num_train == 63
    jpost = jest.posterior.extend(jnp.asarray(x), jnp.asarray(y))
    assert int(jpost.n_real) == 63
    _close([v.ravel() for v in post.predict_mean_std(torch.as_tensor(x))],
           [np.ravel(v) for v in jpost.predict_mean_std(jnp.asarray(x))])
    jest.posterior = jpost
    new = _labeled(9, 3)
    est.extend_with_lines(new)
    jest.extend_with_lines(new)
    assert est.posterior.n_real is None and jest.posterior.n_real is None
    assert est.posterior.num_train == jest.posterior.num_train == 66
    _close(est.predict(LINES), jest.predict(LINES))

    dense = tmp_path / "dense"
    JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                 verbose=False).save(str(dense))
    with open(dense / "meta.json") as f:
        meta = json.load(f)
    with np.load(dense / "posterior.npz") as z:
        arrs = dict(z)
    starts = [0, 16, 40, 60]
    l = arrs.pop("l")
    for i in range(3):
        arrs[f"l_block_{i}"] = l[starts[i]:, starts[i]:starts[i + 1]]
    meta["l_block_starts"] = starts
    blocks = tmp_path / "blocks"
    blocks.mkdir()
    with open(blocks / "meta.json", "w") as f:
        json.dump(meta, f)
    np.savez(blocks / "posterior.npz", **arrs)
    want = Estimator.restore(str(dense), device="cpu").predict(LINES)
    got = Estimator.restore(str(blocks), device="cpu").predict(LINES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ard_feature_scale_rides_a_jax_checkpoint(pair64, tmp_path):
    """A JAX checkpoint of an ARD-learned server carries `feature_scale`;
    the port applies it to every encoded query as the JAX package does."""
    jest, _ = pair64
    jest.save(str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "meta.json") as f:
        meta = json.load(f)
    meta["feature_scale"] = list(np.linspace(0.5, 2.0, 11))
    with open(tmp_path / "ck" / "meta.json", "w") as f:
        json.dump(meta, f)
    est = Estimator.restore(str(tmp_path / "ck"), device="cpu")
    jback = JaxEstimator.restore(str(tmp_path / "ck"))
    _close(est.predict(LINES), jback.predict(LINES))
    new = _labeled(11, 4)
    est.extend_with_lines(new)
    jback.extend_with_lines(new)
    _close(est.predict(LINES), jback.predict(LINES))
    est.save(str(tmp_path / "back"))
    with open(tmp_path / "back" / "meta.json") as f:
        assert json.load(f)["feature_scale"] == meta["feature_scale"]


def test_nystrom_and_distributed_checkpoints_raise(toy, tmp_path):
    """A JAX Nystrom checkpoint restores (it predicts what the JAX
    Estimator predicts; the cross-package cases are in
    test_torch_nystrom_serve.py); a distributed one needs a mesh of its
    fit's size (the restores that work are in
    test_torch_parallel_serve.py)."""
    stats, qdir = toy
    jest = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        nystrom_m=20, verbose=False)
    jest.save(str(tmp_path / "ny"))
    est = Estimator.restore(str(tmp_path / "ny"), device="cpu")
    assert est.nystrom_m == 20 and est.posterior.num_inducing == 20
    _close(est.predict(LINES), jest.predict(LINES))
    with open(tmp_path / "ny" / "meta.json") as f:
        meta = json.load(f)
    del meta["nystrom"]
    meta["distributed"] = {"block_size": 8, "mesh_size": 2}
    with open(tmp_path / "ny" / "meta.json", "w") as f:
        json.dump(meta, f)
    from nngp_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="pass mesh="):
        Estimator.restore(str(tmp_path / "ny"), device="cpu")
    with pytest.raises(ValueError, match="fit on a 2-device mesh"):
        Estimator.restore(str(tmp_path / "ny"),
                          mesh=make_mesh(1, device="cpu"), device="cpu")


def test_online_learning_and_uncertainty_match_jax(toy):
    """extend_with_lines, calibrate_uncertainty, predict_interval and
    record_feedback give what the JAX estimator gives."""
    jest, est = _pair(toy)
    new = _labeled(5, 12)
    assert est.extend_with_lines(new) == jest.extend_with_lines(new) == 12
    assert est.posterior.num_train == jest.posterior.num_train == 72
    _close(est.predict(LINES), jest.predict(LINES))
    held = _labeled(6, 30)
    np.testing.assert_allclose(
        est.calibrate_uncertainty(held, verbose=False),
        jest.calibrate_uncertainty(held, verbose=False), rtol=1e-9)
    np.testing.assert_allclose(est._conformal_scores,
                               jest._conformal_scores, rtol=1e-8)
    _close(est.predict(LINES), jest.predict(LINES))
    _close(est.predict_interval(LINES, alpha=0.1),
           jest.predict_interval(LINES, alpha=0.1))
    for batch in (_labeled(7, 140), _labeled(8, 60, scale=4.0)):
        got, want = est.record_feedback(batch), jest.record_feedback(batch)
        assert (got.drift, got.action, got.n_observed) == \
            (want.drift, want.action, want.n_observed)
        for field in ("mean_abs_z", "median_q_error", "ph_stat",
                      "threshold"):
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=1e-8), field
    assert got.drift and got.action == "relearn_hyperparams"


def test_calibration_holdout_and_quality_best_match_jax(toy):
    """calibrate_frac holds out the same seeded rows as the JAX package;
    quality='best' with learn_hyper=False is chunk_norm plus a 10%
    holdout, which JAX serves as quality='reference' with those flags."""
    stats, qdir = toy
    jest, est = _pair(toy, calibrate_frac=0.2)
    assert est.posterior.num_train == jest.posterior.num_train == 48
    assert est.std_scale == pytest.approx(jest.std_scale, rel=1e-9)
    _close(est.predict(LINES), jest.predict(LINES))
    best = Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                     quality="best", learn_hyper=False, verbose=False,
                     device="cpu")
    jref = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        chunk_norm=True, calibrate_frac=0.1, verbose=False)
    assert best.chunk_norm and best.posterior.num_train == 50
    assert best.std_scale == pytest.approx(jref.std_scale, rel=1e-9)
    _close(best.predict(LINES), jref.predict(LINES))


_QUALITY_CASES = [
    dict(),
    dict(chunk_norm=False, calibrate_frac=0.0),
    dict(hyper_ard=False),
    dict(nystrom_m=2048),
    dict(nystrom_m=2048, dtype=np.float64),
    dict(nystrom_m=2048, nystrom_moments="fp32"),
]


@pytest.mark.parametrize("quality", ["reference", "best"])
@pytest.mark.parametrize("case", range(len(_QUALITY_CASES)))
def test_quality_table_matches_jax_with_the_unset_sentinel(quality, case):
    """learn_hyper left unset: None in the port, False (its sentinel) in
    the JAX package. Every other flag resolves identically."""
    args = dict(chunk_norm=None, hyper_ard=None, nystrom_m=None,
                nystrom_moments=None, dtype=np.float32, calibrate_frac=None)
    args.update(_QUALITY_CASES[case])
    got = list(Estimator.resolve_quality_flags(quality, learn_hyper=None,
                                               **args))
    want = list(JaxEstimator.resolve_quality_flags(quality,
                                                   learn_hyper=False, **args))
    if quality == "reference":
        assert got[1] is None and want[1] is False
        got[1] = want[1]
    assert got == want


def test_explicit_learn_hyper_false_survives_quality_best():
    """The inherited fault: the JAX package turns an explicit
    learn_hyper=False into True under quality='best'; the port keeps it,
    and then also leaves ARD off."""
    args = dict(chunk_norm=None, hyper_ard=None, nystrom_m=None,
                nystrom_moments=None, dtype=np.float32, calibrate_frac=None)
    jax_out = JaxEstimator.resolve_quality_flags("best", learn_hyper=False,
                                                 **args)
    assert jax_out[1] is True and jax_out[2] is True
    assert Estimator.resolve_quality_flags("best", learn_hyper=False,
                                           **args) == (True, False, False,
                                                       None, 0.1)


class _CudaMesh:
    device_type = "cuda"


@pytest.mark.parametrize("kw,err,item", [
    ({"mesh": _CudaMesh()}, ValueError, "mesh is a cuda mesh"),
    ({"dist_block_size": 64}, ValueError, "needs mesh="),
    ({"tier": "distributed"}, ValueError, "requires mesh="),
    ({"pad_slots": 8, "nystrom_m": 32}, ValueError,
     "pad_slots is the single-chip exact-nngp"),
])
def test_unported_arguments_name_their_roadmap_item(toy, kw, err, item):
    """The mesh arguments are ported (tests/test_torch_parallel_serve.py)
    and checked: a mesh of another device type, a panel width or
    tier='distributed' without a mesh raise; pad_slots is ported
    (tests/test_torch_padded.py) and refuses the Nystrom tier as the JAX
    Estimator does."""
    stats, qdir = toy
    args = dict(stats=stats, verbose=False, device="cpu")
    args.update(kw)
    with pytest.raises(err, match=item):
        Estimator("toy", None, qdir, **args)


@pytest.mark.parametrize("kw,m", [
    ({"nystrom_m": 32}, 32),
    ({"nystrom_m": 32, "nystrom_moments": "df64"}, 32),
    ({"tier": "nystrom"}, 60),
    ({"tier": "auto"}, None),
    ({"tier": "auto", "auto_nystrom_m": 24, "exact_max_n": 50}, 24),
    ({"tier": "auto", "exact_max_n": 70000}, None),
])
def test_nystrom_arguments_select_the_tier(toy, kw, m):
    """The Nystrom arguments (once refused, now ported): nystrom_m fits
    the Nystrom tier; tier='nystrom' takes min(auto_nystrom_m, n);
    tier='auto' keeps the exact tier while n <= exact_max_n (55,000 on
    the CPU by default) and routes the 60 toy rows to Nystrom with
    auto_nystrom_m rows when exact_max_n is below them. The JAX
    Estimator routes the same way."""
    stats, qdir = toy
    kw = dict(kw, dtype=np.float32 if "nystrom_moments" in kw
              else np.float64)
    est = Estimator("toy", None, qdir, stats=stats, verbose=False,
                    device="cpu", **kw)
    jest = JaxEstimator("toy", None, qdir, stats=stats, verbose=False, **kw)
    assert est.nystrom_m == jest.nystrom_m == m
    if m is None:
        assert hasattr(est.posterior, "l")
    else:
        assert est.posterior.num_inducing == m
        assert est.posterior.moments == kw.get("nystrom_moments", "fp32")
        rtol = 1e-4 if kw["dtype"] == np.float32 else 1e-7
        _close(est.predict(LINES), jest.predict(LINES), rtol=rtol)


def test_bad_arguments_raise(toy):
    stats, qdir = toy
    with pytest.raises(ValueError, match="tier must be"):
        Estimator("toy", None, qdir, stats=stats, tier="huge", device="cpu")
    with pytest.raises(ValueError, match="quality must be"):
        Estimator("toy", None, qdir, stats=stats, quality="bestest",
                  device="cpu")
    with pytest.raises(TypeError, match="device"):
        Estimator("toy", None, qdir, stats=stats)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Estimator("toy", None, qdir, stats=stats, device="cuda")


def test_memo_hit_launches_nothing_and_dedups(pair64, monkeypatch):
    """A repeated line is predicted once; a line served from the memo
    reaches no predict and no kernel."""
    _, est = pair64
    est.posterior = est.posterior                     # an empty memo
    calls = []
    orig = type(est.posterior).predict_mean_std

    def spy(self, x):
        calls.append(x.shape[0])
        return orig(self, x)

    monkeypatch.setattr(type(est.posterior), "predict_mean_std", spy)
    first = est.predict(LINES)
    assert calls == [64]          # 5 lines, 4 distinct, in the 64-row bucket
    launches = dict(gram_cuda.LAUNCHES)
    again = est.predict(LINES[::-1])
    assert calls == [64] and gram_cuda.LAUNCHES == launches
    for g, w in zip(again, first):
        np.testing.assert_array_equal(g, w[::-1])
    est.predict_cache_size = 0                        # dedup only
    est.posterior = est.posterior
    est.predict(LINES)
    est.predict(LINES)
    assert calls == [64, 64, 64]          # 4 distinct lines, bucketed
    est.predict_cache_size = Estimator.predict_cache_size
    with pytest.raises(ValueError, match="blank query line at index 1"):
        est.predict([LINES[0], "  "])


def test_predict_racing_an_install_cannot_fill_the_new_memo(toy):
    """A predict that reads the memo, then sees the posterior replaced
    (an extend landing meanwhile), stores its results in the memo it read,
    which belongs to the old posterior: the new memo stays empty."""
    jest, est = _pair(toy)
    orig = est.encode_lines

    def encode_while_installing(lines):
        est.posterior = est.posterior.extend(
            orig(["ta,tb@x,3.0,1.0@@ta,tb,id"]), np.array([[11.0]]))
        return orig(lines)

    est.encode_lines = encode_while_installing
    est.predict(LINES[:2])
    assert len(est._pred_cache) == 0 and est.posterior.num_train == 61


def test_extend_is_transactional_and_exact_tier_cannot_forget(pair64):
    _, est = pair64
    before = est.posterior
    with pytest.raises(ValueError, match="card >= 1"):
        est.extend_with_lines(["ta,tb@x,3.0,1.0@@ta,tb,id@0"])
    assert est.posterior is before
    with pytest.raises(NotImplementedError, match="no stable downdate"):
        est.forget_with_lines(_labeled(9, 2))
    with pytest.raises(ValueError, match="exceed the magnitude"):
        est._guard_feature_magnitude(
            np.full((1, 11), 2.0 ** 21, np.float32), "extend_with_lines")


def test_python_encoder_fallback_is_visible_and_equal(toy, pair64,
                                                      monkeypatch, capsys):
    import nngp_tpu_torch.native

    stats, qdir = toy
    monkeypatch.setattr(nngp_tpu_torch.native, "is_available", lambda: False)
    est = Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                    verbose=False, device="cpu")
    assert est.encoder_kind == "python"
    assert "Python encoder" in capsys.readouterr().err
    for g, w in zip(est.predict(LINES), pair64[1].predict(LINES)):
        np.testing.assert_array_equal(g, w)
    x, cards = est._encode_labeled_lines(_labeled(10, 3), "test")
    np.testing.assert_array_equal(
        x, pair64[1]._encode_labeled_lines(_labeled(10, 3), "test")[0])


def test_load_model_and_warmup_leave_the_model_alone(pair64, capsys):
    _, est = pair64
    post = est.posterior
    est.posterior = post
    est.load_model()
    assert "Model construction complete." in capsys.readouterr().out
    assert est.warmup(max_batch=64, verbose=False) == [64]  # the buckets
    assert est.posterior is post and len(est._pred_cache) == 0


def test_jax_checkpoint_restores_with_a_custom_spec(toy, tmp_path):
    from nngp_tpu.models.kernel_spec import KernelSpec as JaxSpec, mlp

    stats, qdir = toy
    jest = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        spec=JaxSpec(mlp(depth=2, width=64,
                                         activation="erf")),
                        verbose=False)
    jest.save(str(tmp_path / "ck"))
    est = Estimator.restore(str(tmp_path / "ck"), device="cpu")
    assert [type(l).__name__ for l in est.spec.layers] == \
        ["Dense", "Activation", "Dense", "Activation", "Dense"]
    assert os.path.exists(tmp_path / "ck" / "posterior.npz")
    _close(est.predict(LINES), jest.predict(LINES))
    np.testing.assert_array_equal(
        est.posterior.x_train.numpy(), np.asarray(jest.posterior.x_train))
    assert float(est.posterior.reg) == float(jnp.asarray(jest.posterior.reg))


# ------------------------------------------------ learned hyperparameters
HYPER = dict(hyper_steps=8, hyper_points=48)


@pytest.fixture(scope="module")
def learned(toy):
    """(JAX, port) Estimators with ARD hyperparameters learned by
    evidence, and the scalar pair (the JAX fit on its exact-diagonal
    path)."""
    return {ard: _pair(toy, learn_hyper=True, hyper_ard=ard, **HYPER)
            for ard in (True, False)}


def _close_hyper(res, jres, rtol=1e-6):
    for field in ("w0", "w", "b", "diag_reg", "log_evidence"):
        assert getattr(res, field) == pytest.approx(getattr(jres, field),
                                                    rel=rtol), field
    if jres.feature_scale is not None:
        np.testing.assert_allclose(res.feature_scale, jres.feature_scale,
                                   rtol=rtol)


@pytest.mark.parametrize("ard", [True, False], ids=["ard", "scalar"])
def test_learned_estimator_matches_jax(learned, ard):
    """learn_hyper=True (hyper_ard on and off): the same learned values
    (rtol 1e-6), the ARD scale applied to every query, predictions within
    rtol 1e-9."""
    jest, est = learned[ard]
    _close_hyper(est.hyper_result, jest.hyper_result)
    assert (est.feature_scale is None) == (not ard)
    assert est.spec.layers[0].b_std == est.hyper_result.b
    _close(est.predict(LINES), jest.predict(LINES))


def test_quality_best_learns_as_jax_does(toy):
    """quality='best' now learns: chunk_norm, ARD hyperparameters and a
    10% calibration holdout, as the JAX package routes it."""
    stats, qdir = toy
    kw = dict(stats=stats, dtype=np.float64, verbose=False, quality="best",
              **HYPER)
    # each package's unset sentinel: False in JAX, None in the port
    jest = JaxEstimator("toy", None, qdir, learn_hyper=False, **kw)
    est = Estimator("toy", None, qdir, device="cpu", **kw)
    assert est.chunk_norm and est.feature_scale is not None
    assert est.posterior.num_train == jest.posterior.num_train == 50
    _close_hyper(est.hyper_result, jest.hyper_result)
    assert est.std_scale == pytest.approx(jest.std_scale, rel=1e-8)
    _close(est.predict(LINES), jest.predict(LINES))


def test_learned_checkpoints_load_in_either_package(learned, tmp_path):
    """A checkpoint carries the learned spec and the ARD scale: the JAX
    one restores in the port and the port's in JAX, each predicting what
    the other did (rtol 1e-9)."""
    jest, est = learned[True]
    jest.save(str(tmp_path / "jax"))
    est.save(str(tmp_path / "port"))
    back = Estimator.restore(str(tmp_path / "jax"), device="cpu")
    jback = JaxEstimator.restore(str(tmp_path / "port"))
    assert back.spec.layers[0].w_std == jest.spec.layers[0].w_std
    np.testing.assert_array_equal(back.feature_scale, jest.feature_scale)
    np.testing.assert_array_equal(jback.feature_scale, est.feature_scale)
    _close(back.predict(LINES), jest.predict(LINES))
    _close(jback.predict(LINES), est.predict(LINES))


def test_hyper_artifacts_from_either_package_serve_alike(toy, learned,
                                                         tmp_path):
    """learn_hyper=<HyperoptResult>: a JAX-written artifact installed in
    the port serves what the JAX Estimator serves with it, and the
    reverse (rtol 1e-9)."""
    from nngp_tpu.gp.hyperopt import HyperoptResult as JaxResult
    from nngp_tpu_torch.gp.hyperopt import HyperoptResult

    stats, qdir = toy
    jest, est = learned[True]
    jest.hyper_result.save(str(tmp_path / "jax.json"))
    est.hyper_result.save(str(tmp_path / "port.json"))
    on_port = Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                        verbose=False, device="cpu",
                        learn_hyper=HyperoptResult.load(
                            str(tmp_path / "jax.json")))
    on_jax = JaxEstimator("toy", None, qdir, stats=stats, dtype=np.float64,
                          verbose=False,
                          learn_hyper=JaxResult.load(
                              str(tmp_path / "port.json")))
    _close(on_port.predict(LINES), jest.predict(LINES))
    _close(on_jax.predict(LINES), est.predict(LINES))


def test_hyper_artifact_guards_raise_like_jax(toy, learned):
    """_apply_hyper_result's provenance and range guards and hyper_ard
    with a scalar artifact raise ValueError in both packages."""
    stats, qdir = toy
    res = learned[True][1].hyper_result
    scalar = learned[False][1].hyper_result
    cases = [
        (dict(learn_hyper=dataclasses.replace(res, num_features=7)),
         "learned on 7 features"),
        (dict(learn_hyper=dataclasses.replace(res, get="ntk")),
         "maximized the 'ntk' evidence"),
        (dict(learn_hyper=scalar, hyper_ard=True), "scalar-mode"),
        (dict(learn_hyper=dataclasses.replace(
            scalar, feature_scale=np.full(11, 2.0 ** 30)),
            dtype=np.float32), "exceeds the fp32-safe range"),
        (dict(hyper_ard=True), "hyper_ard requires learn_hyper"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            Estimator("toy", None, qdir, stats=stats, verbose=False,
                      device="cpu", **{"dtype": np.float64, **kw})


def test_learn_requires_an_mlp_spec_and_a_safe_range(toy):
    from nngp_tpu_torch.models.kernel_spec import Activation, Dense

    stats, qdir = toy
    odd = KernelSpec((Dense(64), Activation("relu"), Dense(64),
                      Activation("erf"), Dense(1)))
    with pytest.raises(ValueError, match="mlp-shaped spec"):
        Estimator("toy", None, qdir, stats=stats, spec=odd, verbose=False,
                  learn_hyper=True, device="cpu", **HYPER)
    _, est = _pair(toy)
    with pytest.raises(ValueError, match="fp32-safe range"):
        est._learn_hyperparams(np.full((4, 11), 2.0 ** 21), np.ones((4, 1)),
                               5, 48, False)
    with pytest.raises(ValueError, match="requires the DTC objective"):
        est._learn_hyperparams(np.ones((4, 11)), np.ones((4, 1)), 5, 0,
                               False)


def test_relearn_after_extend_matches_jax(toy):
    """extend_with_lines, then relearn_hyperparams (warm, from the
    posterior's own rows): the same relearned values and predictions."""
    jest, est = _pair(toy, learn_hyper=True, hyper_ard=True, **HYPER)
    new = _labeled(12, 20, scale=3.0)
    est.extend_with_lines(new)
    jest.extend_with_lines(new)
    kw = dict(steps=6, max_points=48, verbose=False)
    assert est.relearn_hyperparams(**kw) == pytest.approx(
        jest.relearn_hyperparams(**kw), rel=1e-6)
    _close_hyper(est.hyper_result, jest.hyper_result)
    assert est.posterior.num_train == jest.posterior.num_train == 80
    _close(est.predict(LINES), jest.predict(LINES), rtol=1e-8)
    lines = _labeled(13, 30)
    kw["verbose"] = True
    est.relearn_hyperparams(lines, **kw)
    assert est.posterior.num_train == 30


def test_relearn_rolls_back_on_any_failure(learned, monkeypatch):
    """A refit that raises leaves the spec, ridge, ARD scale, posterior
    and hyperparameter result of before in place."""
    _, est = learned[True]
    before = (est.spec, est.diag_reg, est.feature_scale, est.posterior,
              est.hyper_result)
    want = est.predict(LINES)

    def broken_fit(x, y):
        raise RuntimeError("device lost mid-refit")

    monkeypatch.setattr(est, "_fit", broken_fit)
    with pytest.raises(RuntimeError, match="device lost"):
        est.relearn_hyperparams(steps=3, verbose=False)
    after = (est.spec, est.diag_reg, est.feature_scale, est.posterior,
             est.hyper_result)
    assert all(a is b for a, b in zip(after, before))
    for g, w in zip(est.predict(LINES), want):
        np.testing.assert_array_equal(g, w)
