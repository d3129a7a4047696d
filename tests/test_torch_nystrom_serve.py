"""The Nystrom tier's serving, routing and learning surfaces in the port
against the JAX package, on the CPU: the Estimator (fit, tier routing,
quality='best', forget and grow; its checkpoints in both directions are in
test_torch_nystrom_checkpoint.py), the socket server's growth remediation,
the ActiveLearner, and the three CLIs' Nystrom flags, on the toy
two-table schema of
`tests/test_active_serve.py` and the committed forest and synth
workloads.

Tolerances: fp64 predictions rtol 1e-9 (the same products summed in other
orders, through a whitening of condition ~1e4), ntk 1e-7 (see
test_torch_nystrom.py); moments='df64' rtol 1e-4 (fp32 rows, ic, beta and
predict); fp32 moments 2e-3 (the predict's fp32 kernel entries are
amplified by the whitening, up to sqrt(lam_max / lam_cut) = 1e4 at the
1e-8 cut); learned hyperparameters rtol 1e-6.
"""

import os
import time

import numpy as np
import pytest
import torch

from nngp_tpu.active import ActiveLearner as JaxLearner
from nngp_tpu.cli import active_train as jax_active_cli
from nngp_tpu.cli import train as jax_train
from nngp_tpu.models.kernel_spec import reference_kernel as jax_reference
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.active import ActiveLearner
from nngp_tpu_torch.cli import active_train, train
from nngp_tpu_torch.gp import NystromPosterior, fit_nystrom
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from nngp_tpu_torch.serve import Estimator, EstimatorSocketServer
from nngp_tpu_torch.serve import estimator as est_mod
from tests.test_active_serve import _toy_schema_files
from tests.test_socket_server import _client, _mk_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")
SYNTH = os.path.join(REPO, "workloads", "synth_join_data")
LINES = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id",
         "ta,tb@x,1.0,-2.0@@ta,tb,id", "ta,tb@x,9.5,0.5@@ta,tb,id"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


def _close(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w))))


def _pair(toy, **kw):
    stats, qdir = toy
    kw.setdefault("dtype", np.float64)
    jest = JaxEstimator("toy", None, qdir, stats=stats, verbose=False, **kw)
    est = Estimator("toy", None, qdir, stats=stats, verbose=False,
                    device="cpu", **kw)
    return jest, est


# -------------------------------------------------------------- Estimator
@pytest.mark.parametrize("kernel_type", ["nngp", "ntk"])
def test_estimator_fit_is_a_direct_fit_nystrom(toy, kernel_type):
    """The Estimator's Nystrom fit is `fit_nystrom` of its encoded rows,
    and serves what the JAX Estimator serves; load_model warms up on the
    inducing rows; the exact tier's refusals name their reason."""
    jest, est = _pair(toy, nystrom_m=24, kernel_type=kernel_type)
    post = est.posterior
    assert isinstance(post, NystromPosterior) and post.num_inducing == 24
    assert est._feature_dim() == post.x_m.shape[1]
    est.load_model(verbose=False)
    stats, qdir = toy
    queries, cards, _ = est.encoder.load_queries(qdir)
    x, y = est.encoder.transform_to_arrays(queries, cards, dtype=np.float64)
    direct = fit_nystrom(est.spec, x, y, num_inducing=24, get=kernel_type,
                         device="cpu")
    mean, std = est.predict(LINES)
    dm, ds = direct.predict_mean_std_chunked(est.encode_lines(LINES))
    _close((mean, std), (dm, ds), 1e-12)
    _close((mean, std), jest.predict(LINES), 1e-7 if kernel_type == "ntk"
           else 1e-9)
    exact = Estimator("toy", None, qdir, stats=stats, verbose=False,
                      dtype=np.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="inducing set"):
        exact.grow_inducing(_mk_lines(np.random.default_rng(0), 4))
    with pytest.raises(NotImplementedError, match="no stable downdate"):
        exact.forget_with_lines(_mk_lines(np.random.default_rng(0), 4))


def test_forget_and_grow_with_lines_match_jax(toy):
    """forget_with_lines inverts extend_with_lines; grow_inducing enlarges
    the inducing set from the given lines and refits on them; both as the
    JAX Estimator does, and transactional."""
    jest, est = _pair(toy, nystrom_m=20)
    stats, qdir = toy
    new = _mk_lines(np.random.default_rng(3), 12)
    base = est.predict(LINES)
    for e in (est, jest):
        assert e.extend_with_lines(new) == 12
    _close(est.predict(LINES), jest.predict(LINES), 1e-9)
    for e in (est, jest):
        assert e.forget_with_lines(new) == 12
    assert est.posterior.num_train == 60
    _close(est.predict(LINES), base, 1e-9)
    with open(os.path.join(qdir, "join_query_2.txt")) as f:
        log = [l.strip() for l in f if l.strip()]
    elbo0 = est.posterior.elbo()
    assert est.grow_inducing(log, num_new=16, seed=2) == 36
    assert jest.grow_inducing(log, num_new=16, seed=2) == 36
    assert est.nystrom_m == 36 and est.posterior.elbo() >= elbo0
    _close(est.predict(LINES), jest.predict(LINES), 1e-9)
    before = est.posterior
    with pytest.raises(ValueError, match="card >= 1"):
        est.forget_with_lines(["ta,tb@x,3.0,1.0@@ta,tb,id@0"])
    assert est.posterior is before
    with pytest.raises(ValueError, match="labeled_lines"):
        est.relearn_hyperparams()


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_exact_max_n_rule(monkeypatch, get):
    """The default bound of tier='auto': 55,000 on the CPU; on a card the
    largest n whose exact-tier peak, EXACT_PEAK_BYTES_PER_N2 bytes per
    n^2 for the kernel and dtype (the column-block factor's), stays within
    80% of its memory: about 126k fp32 and 89-90k fp64 on an 80 GB H100,
    synth6_big's 90,000 rows in nngp fp64 among them. The dense layout's cap,
    dense_exact_max_n (DENSE_PEAK_BYTES_PER_N2: about 74k fp32 and 53k
    fp64 nngp, fewer for an ntk posterior, which also keeps the train NNGP
    Gram), is the layout switch: 27,999 on the CPU."""
    assert est_mod.default_exact_max_n("cpu", np.float32, get) == 55000
    assert est_mod.default_exact_max_n("cpu", torch.float64, get) == 55000
    assert est_mod.dense_exact_max_n("cpu", np.float32, get) == 27999

    class Props:
        total_memory = 85_029_158_912        # an NVIDIA H100 80GB HBM3

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    caps = {}
    for rule, peaks in ((est_mod.default_exact_max_n,
                         est_mod.EXACT_PEAK_BYTES_PER_N2),
                        (est_mod.dense_exact_max_n,
                         est_mod.DENSE_PEAK_BYTES_PER_N2)):
        for dtype in (torch.float32, torch.float64):
            n_max = caps[rule, dtype] = rule("cuda", dtype, get)
            per = peaks[get, dtype]
            assert n_max ** 2 * per <= 0.8 * Props.total_memory
            assert (n_max + 1) ** 2 * per > 0.8 * Props.total_memory
    block = est_mod.default_exact_max_n
    dense = est_mod.dense_exact_max_n
    assert caps[block, torch.float32] == block("cuda", np.float32, get)
    assert 115000 < caps[block, torch.float32] < 135000
    assert 85000 < caps[block, torch.float64] < 95000
    if get == "nngp":
        assert caps[block, torch.float64] >= 90000
        assert 70000 < caps[dense, torch.float32] < 78000
        assert 50000 < caps[dense, torch.float64] < 56000
        assert est_mod.default_exact_max_n("cuda", np.float32) == \
            caps[block, torch.float32]
    else:
        assert caps[dense, torch.float32] < dense("cuda", np.float32, "nngp")
        assert caps[dense, torch.float64] < dense("cuda", np.float64, "nngp")


def test_quality_best_routes_df64_moments(toy):
    """quality='best' in fp32 picks moments='df64' for the Nystrom tier,
    whether nystrom_m is given or tier='auto' routes there; an explicit
    nystrom_moments wins."""
    stats, qdir = toy
    common = dict(stats=stats, verbose=False, device="cpu",
                  dtype=np.float32, quality="best", learn_hyper=False)
    for kw, want in (({"nystrom_m": 24}, "df64"),
                     ({"tier": "auto", "exact_max_n": 10,
                       "auto_nystrom_m": 24}, "df64"),
                     ({"nystrom_m": 24, "nystrom_moments": "fp32"}, "fp32")):
        est = Estimator("toy", None, qdir, **common, **kw)
        assert est.posterior.moments == want and est.chunk_norm
        assert est._conformal_scores is not None      # the 10% holdout


def test_learn_hyper_uses_the_dtc_objective_on_the_nystrom_tier(toy):
    """learn_hyper with nystrom_m maximizes the DTC evidence with
    min(512, m) inducing rows, as the JAX Estimator does."""
    jest, est = _pair(toy, nystrom_m=16, learn_hyper=True, hyper_steps=4,
                      hyper_points=48)
    assert est.hyper_result.objective == jest.hyper_result.objective == "dtc"
    for key in ("w0", "w", "b", "diag_reg", "log_evidence"):
        assert getattr(est.hyper_result, key) == pytest.approx(
            getattr(jest.hyper_result, key), rel=1e-6), key
    _close(est.predict(LINES), jest.predict(LINES), 1e-6)


# --------------------------------------------------------- socket server
def _serve_drift(est, train_log, rng):
    """Healthy then drifted feedback over the wire in 'auto' mode; the
    server's stats once a remediation ran or was skipped."""
    healthy = _mk_lines(rng, 150)
    drifted = _mk_lines(rng, 150, lo_scale=4.0)
    with EstimatorSocketServer(est, port=0, feedback_mode="auto",
                               feedback_batch=512, feedback_flush_s=0.2,
                               train_log=train_log) as srv:
        _client(srv.host, srv.port, healthy)
        deadline = time.monotonic() + 60
        while (srv.stats().get("feedback_lines", 0) < 150
               and time.monotonic() < deadline):
            time.sleep(0.1)
        _client(srv.host, srv.port, drifted)
        deadline = time.monotonic() + 120
        while (srv.stats()["remediations"] + srv.stats()[
                "remediations_skipped"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.2)
        st = srv.stats()
        replies = _client(srv.host, srv.port,
                          _mk_lines(rng, 3, labeled=False))
    assert all("mean" in r for r in replies)
    assert st["drift_alarms"] >= 1 and st["feedback_errors"] == 0
    assert est.drift_monitor.drift is False        # reset: no latch loop
    return st


@pytest.mark.parametrize("with_log", [False, True],
                         ids=["no-log", "train-log"])
def test_socket_auto_remediation_grows_the_inducing_set(toy, with_log):
    """feedback_mode='auto' on the Nystrom tier: a drift alarm's
    remediation is grow_inducing over train_log (the query directory) plus
    the feedback received; without a train_log it is skipped and counted,
    as in the JAX server (tests/test_socket_server.py)."""
    stats, qdir = toy
    est = Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                    verbose=False, nystrom_m=40, device="cpu")
    m0 = est.posterior.num_inducing
    st = _serve_drift(est, qdir if with_log else None,
                      np.random.default_rng(8))
    if with_log:
        assert st["remediations"] >= 1 and st["remediations_skipped"] == 0
        assert est.posterior.num_inducing > m0
    else:
        assert st["remediations"] == 0 and st["remediations_skipped"] >= 1
        assert est.posterior.num_inducing == m0


# -------------------------------------------------------- active learning
@pytest.mark.parametrize("kw", [
    {"selection": "greedy"},
    {"selection": "topk", "relearn_hyper": True, "hyper_warm_steps": 3,
     "hyper_points": 48},
], ids=["greedy", "dtc-relearn"])
def test_active_learner_on_the_nystrom_tier_matches_jax(kw):
    """Greedy selection on the Nystrom posterior's covariance, and a
    per-round relearn against the DTC evidence, as the JAX learner does."""
    rng = np.random.default_rng(5)
    split = []
    for m in (80, 160, 40):
        x = rng.integers(0, 1000, (m, 6)).astype(np.float64)
        split += [x, np.sin(x[:, :1] / 200.0) * 8.0 + 8.0]
    jkw = {k: v for k, v in kw.items() if k != "selection"}
    jl = JaxLearner(jax_reference(), budget=16, active_iters=2,
                    biased_sample=False, selection=kw["selection"],
                    nystrom_m=24, **jkw)
    tl = ActiveLearner(reference_kernel(), budget=16, active_iters=2,
                       nystrom_m=24, device="cpu", **kw)
    _, jhist = jl.active_train(*split, printer=None)
    post, hist = tl.active_train(*split, printer=None)
    assert isinstance(post, NystromPosterior)
    assert [h["num_train"] for h in hist] == [h["num_train"] for h in jhist]
    np.testing.assert_allclose([h["val_mse"] for h in hist],
                               [h["val_mse"] for h in jhist],
                               rtol=1e-6 if "relearn_hyper" in kw else 1e-9)
    if "relearn_hyper" in kw:
        assert tl._hyper.objective == "dtc"


# ------------------------------------------------------------------ CLIs
def test_train_cli_learn_hyper_resolves_to_dtc(capsys):
    """--nystrom_m with --learn_hyper learns on the DTC evidence (auto),
    as the JAX CLI does: the same learned line and profile."""
    argv = ["--x64", "--query_path", FOREST, "--max_num_train", "300",
            "--nystrom_m", "64", "--learn_hyper", "--hyper_points", "96",
            "--hyper_steps", "6"]
    want = jax_train.main(argv)
    jax_out = capsys.readouterr().out
    got = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out

    def learned(text):
        return [l for l in text.splitlines()
                if l.startswith("learned hyperparameters")]

    assert learned(out) == learned(jax_out) and "(dtc log" in learned(out)[0]
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_active_cli_learn_hyper_resolves_to_dtc(capsys):
    argv = ["--x64", "--schema_name", "synth", "--query_path", SYNTH,
            "--budget", "40", "--active_iters", "1", "--selection", "topk",
            "--nystrom_m", "48", "--learn_hyper", "--hyper_points", "64",
            "--hyper_steps", "4"]
    want = jax_active_cli.main(argv)
    jax_out = capsys.readouterr().out
    got = active_train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("learned")]
    assert line == [l for l in jax_out.splitlines()
                    if l.startswith("learned")]
    assert "(dtc log evidence" in line[0]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-6)


def test_serve_demo_tier_auto_routes_by_exact_max_n(toy, tmp_path, capsys,
                                                    monkeypatch):
    """--tier auto serves from the exact tier below exact_max_n and from
    the Nystrom tier above it (here a bound of 50 rows for the 60)."""
    from nngp_tpu_torch.cli import serve_demo

    stats, qdir = toy
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    for i, s in enumerate(stats):
        s.save(str(stats_dir / f"{i}_{s.table_name}.json"))
    test_file = tmp_path / "test.txt"
    test_file.write_text("\n".join(_mk_lines(np.random.default_rng(2), 4))
                         + "\n")
    argv = ["--device", "cpu", "--schema_name", "toy", "--stats_dir",
            str(stats_dir), "--train_query_path", qdir, "--test_query_file",
            str(test_file), "--tier", "auto"]
    serve_demo.main(argv)
    assert "n=60 -> exact" in capsys.readouterr().out
    monkeypatch.setattr(est_mod, "default_exact_max_n",
                        lambda device, dtype, get: 50)
    serve_demo.main(argv)
    out = capsys.readouterr().out
    assert "n=60 -> nystrom (m=60, moments=fp32)" in out
    assert "predicted 4 queries" in out
