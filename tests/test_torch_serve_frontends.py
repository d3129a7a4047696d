"""The port's serving front ends (`nngp_tpu_torch.serve.streaming`,
`socket_server`, `drift`, `feedback`) and its serving demo, on the CPU.

The cases of tests/test_streaming.py and tests/test_socket_server.py run
against the port's copies, merged into parametrised tests where they
repeat; the two streaming faults the port fixes are shown against both
modules; drift and feedback outputs equal the JAX package's on the same
inputs; and, in a fresh interpreter with jax and pandas blocked, the
serving package and the demo import and serve.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import nngp_tpu.serve.drift as jax_drift
import nngp_tpu.serve.feedback as jax_feedback
import nngp_tpu.serve.streaming as jax_streaming
import nngp_tpu_torch.serve.drift as drift
import nngp_tpu_torch.serve.feedback as feedback
import nngp_tpu_torch.serve.streaming as streaming
from nngp_tpu_torch.serve import Estimator, EstimatorSocketServer
from nngp_tpu_torch.serve.socket_server import _is_labeled
from nngp_tpu_torch.serve.streaming import StreamingBatcher
from tests.test_active_serve import _toy_schema_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(rng, n, labeled=False, scale=1.0):
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        base = f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id"
        card = max(1, int(scale * 1000 * (xu - xl)))
        out.append(f"{base}@{card}" if labeled else base)
    return out


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


def _estimator(toy):
    stats, qdir = toy
    return Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                     verbose=False, device="cpu")


@pytest.fixture(scope="module")
def est(toy):
    """A shared estimator for tests that do not change it."""
    return _estimator(toy)


# ---------------------------------------------------------------- streaming
def test_streaming_matches_direct_predict(est):
    lines = _lines(np.random.default_rng(1), 50)
    want_mean, want_std = est.predict(lines)
    with StreamingBatcher(est.predict, max_wait_ms=20.0) as server:
        futs = [server.submit(l) for l in lines]
        got = [f.result(timeout=30) for f in futs]
        st = server.stats()
    np.testing.assert_allclose([m for m, _ in got], want_mean, rtol=1e-10)
    np.testing.assert_allclose([s for _, s in got], want_std, rtol=1e-10,
                               atol=1e-12)
    assert st["batches"] < 10 and st["requests"] == 50


def test_streaming_concurrent_clients(est):
    lines = _lines(np.random.default_rng(2), 20)
    want_mean, _ = est.predict(lines)
    results = {}
    with StreamingBatcher(est.predict, max_wait_ms=10.0) as server:
        def client(cid):
            results[cid] = server.predict(lines)[0]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = server.stats()
    assert not any(t.is_alive() for t in threads)
    for cid in range(6):
        np.testing.assert_allclose(results[cid], want_mean, rtol=1e-10)
    assert st["requests"] == 120 and st["batches"] < 120
    assert st["p95_latency_ms"] >= st["p50_latency_ms"] >= 0.0


def test_streaming_max_batch_close_and_drain():
    calls = []

    def ok_fn(items):
        time.sleep(0.01)
        calls.append(len(items))
        v = np.arange(len(items), dtype=float)
        return v, v + 0.5

    server = StreamingBatcher(ok_fn, max_batch=8, max_wait_ms=1.0)
    futs = [server.submit(i) for i in range(30)]
    server.close(timeout=30)
    assert all(f.done() for f in futs) and sum(calls) == 30
    assert all(b <= 8 for b in calls)
    assert futs[0].result(timeout=1) == (0.0, 0.5)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit("late")


def _sync(predict):
    return dict(predict_fn=predict)


def _pipelined(predict):
    return dict(dispatch_fn=lambda items: items, fetch_fn=predict)


@pytest.mark.parametrize("mode", [_sync, _pipelined],
                         ids=["sync", "pipelined"])
def test_bad_items_fail_alone(mode):
    """A failing item fails only its own future: the batch is bisected and
    the rest resolve; a predict that drops an item fails that item (the
    length check), never hands a neighbour's result over."""
    def predict(items):
        if "bad" in items:
            raise ValueError("malformed query line")
        kept = [i for i in items if i != "blank"]
        v = np.arange(len(kept), dtype=float)
        return v, v + 0.5

    with StreamingBatcher(max_batch=16, max_wait_ms=30.0,
                          **mode(predict)) as srv:
        futs = [srv.submit(x) for x in ("ok1", "bad", "ok2", "blank")]
        assert futs[0].result(timeout=30) == (0.0, 0.5)
        assert futs[2].result(timeout=30) == (0.0, 0.5)
        with pytest.raises(ValueError, match="malformed"):
            futs[1].result(timeout=30)
        with pytest.raises(ValueError, match="0 results"):
            futs[3].result(timeout=30)


def test_concurrent_soak_with_random_failures():
    def predict(items):
        if any(it < 0 for it in items):
            raise ValueError("bad item")
        vals = np.asarray([float(it) for it in items])
        return vals, vals * 0.1

    rng = np.random.default_rng(0)
    requests = [int(v) if ok else -1
                for v, ok in zip(rng.integers(1, 1000, 400),
                                 rng.random(400) > 0.1)]
    results = [None] * len(requests)
    with StreamingBatcher(predict, max_batch=32, max_wait_ms=2.0) as srv:
        def client(lo, hi):
            futs = [(i, srv.submit(requests[i])) for i in range(lo, hi)]
            for i, f in futs:
                try:
                    results[i] = f.result(timeout=60)
                except ValueError:
                    results[i] = "error"

        threads = [threading.Thread(target=client,
                                    args=(i * 50, (i + 1) * 50))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for req, res in zip(requests, results):
        assert res == ("error" if req < 0
                       else (float(req), float(req) * 0.1))


def test_cancelled_future_does_not_kill_dispatcher():
    def predict(items):
        if "bad" in items:
            raise ValueError("boom")
        time.sleep(0.05)
        v = np.asarray([float(i) for i in items])
        return v, v

    with StreamingBatcher(predict, max_batch=8, max_wait_ms=2.0) as srv:
        f1, f2, f3 = srv.submit(1.0), srv.submit("bad"), srv.submit(3.0)
        f1.cancel()
        for _ in range(3):
            assert srv.submit(7.0).result(timeout=30) == (7.0, 7.0)
        with pytest.raises(ValueError):
            f2.result(timeout=30)
        assert f3.result(timeout=30) == (3.0, 3.0)


def test_quiet_gap_burst_capture_trickle_and_backlog():
    calls = []

    def predict(items):
        calls.append(len(items))
        v = np.asarray([float(i) for i in items])
        return v, v

    with StreamingBatcher(predict, max_batch=256, quiet_gap_ms=50.0,
                          max_wait_ms=500.0) as srv:
        futs = [srv.submit(float(i)) for i in range(100)]
        for i, f in enumerate(futs):
            assert f.result(timeout=30) == (float(i), float(i))
        assert srv.stats()["batches"] == 1
    with StreamingBatcher(predict, max_batch=256, quiet_gap_ms=5.0,
                          max_wait_ms=10_000.0) as srv:
        t0 = time.monotonic()
        assert srv.submit(4.0).result(timeout=30) == (4.0, 4.0)
        assert time.monotonic() - t0 < 2.0

    def slow(items):
        time.sleep(0.02)
        return predict(items)

    calls.clear()
    with StreamingBatcher(slow, max_batch=4096, quiet_gap_ms=2.0,
                          max_wait_ms=25.0) as srv:
        for f in [srv.submit(float(i)) for i in range(500)]:
            f.result(timeout=30)
        burst_batches = len(calls)
        t0 = time.perf_counter()
        futs = []
        for i in range(200):
            futs.append(srv.submit(float(i)))
            time.sleep(0.0002)
        for f in futs:
            f.result(timeout=30)
        wall = time.perf_counter() - t0
        assert srv.stats()["requests"] == 700
    assert burst_batches <= 3 and wall < 1.0


def test_stats_latency_decomposition():
    def slow_predict(rows):
        time.sleep(0.02)
        v = np.asarray([float(np.sum(r)) for r in rows])
        return v, np.abs(v) + 1.0

    with StreamingBatcher(slow_predict, max_batch=64,
                          quiet_gap_ms=1.0) as srv:
        for f in [srv.submit(np.full(3, i, np.float32)) for i in range(100)]:
            f.result(timeout=30)
        st = srv.stats()
    assert st["p50_service_ms"] >= 20.0
    assert st["p95_latency_ms"] >= st["p95_service_ms"] - 1.0
    assert st["p95_latency_ms"] >= st["p95_queue_wait_ms"] - 1.0


def test_pipelined_mode_results_and_validation():
    def fetch(v):
        time.sleep(0.03)
        v = np.asarray([float(np.sum(r)) for r in v])
        return v, np.abs(v) + 1.0

    with StreamingBatcher(dispatch_fn=lambda rows: rows, fetch_fn=fetch,
                          max_batch=8, quiet_gap_ms=1.0) as srv:
        out = [f.result(timeout=30) for f in
               [srv.submit(np.full(2, i, np.float32)) for i in range(32)]]
        st = srv.stats()
    for i, (m, s) in enumerate(out):
        assert m == 2.0 * i and s == abs(m) + 1.0
    assert st["requests"] == 32 and st["batches"] >= 4
    assert st["p95_service_ms"] >= 30.0
    with pytest.raises(ValueError, match="BOTH"):
        StreamingBatcher(lambda r: (r, r), dispatch_fn=lambda r: r)
    with pytest.raises(ValueError, match="predict_fn"):
        StreamingBatcher()


# ------------------------------------------------------------ fixed faults
@pytest.mark.parametrize("module,fixed", [(jax_streaming, False),
                                          (streaming, True)],
                         ids=["jax", "port"])
def test_dispatch_failure_finishes_the_batch_in_flight_first(module, fixed):
    """Batch a is in flight when batch b's dispatch fails. The port fetches
    and finishes a before it re-runs b synchronously; the JAX module
    re-runs b first and leaves a's clients waiting behind it."""
    events = []
    b_queued = threading.Event()

    def dispatch(items):
        events.append(("dispatch", tuple(items)))
        if items == ["a"]:
            b_queued.wait(10)          # b is queued before a ships
        if "b" in items:
            raise RuntimeError("dispatch failed")
        return items

    def fetch(items):
        events.append(("fetch", tuple(items)))
        v = np.zeros(len(items))
        return v, v

    with module.StreamingBatcher(dispatch_fn=dispatch, fetch_fn=fetch,
                                 max_batch=1, quiet_gap_ms=1.0) as srv:
        fa, fb = srv.submit("a"), srv.submit("b")
        b_queued.set()
        assert fa.result(timeout=30) == (0.0, 0.0)
        with pytest.raises(RuntimeError, match="dispatch failed"):
            fb.result(timeout=30)
    fetch_a = events.index(("fetch", ("a",)))
    rerun_b = [i for i, e in enumerate(events) if e == ("dispatch", ("b",))]
    assert len(rerun_b) == 2
    assert (fetch_a < rerun_b[1]) is fixed


@pytest.mark.parametrize("module,fixed", [(jax_streaming, False),
                                          (streaming, True)],
                         ids=["jax", "port"])
def test_single_item_retry_counts_as_service_time(module, fixed):
    """A failed fetch of a one-item batch is retried through the
    synchronous path, which here takes 0.2 s. The port ships the retry
    before it runs, so those 0.2 s are service time; the JAX module takes
    the ship time after the retry and books them as queue wait."""
    calls = []

    def fetch(items):
        calls.append(len(items))
        if len(calls) == 1:
            raise RuntimeError("fetch failed")
        time.sleep(0.2)
        v = np.ones(len(items))
        return v, v

    with module.StreamingBatcher(dispatch_fn=lambda items: items,
                                 fetch_fn=fetch, max_batch=1,
                                 quiet_gap_ms=1.0) as srv:
        assert srv.submit("q").result(timeout=30) == (1.0, 1.0)
        st = srv.stats()
    if fixed:
        assert st["p50_service_ms"] >= 200.0
        assert st["p50_queue_wait_ms"] < 100.0
    else:
        assert st["p50_service_ms"] < 100.0
        assert st["p50_queue_wait_ms"] >= 200.0


# ------------------------------------------------------------------ socket
class _StubEstimator:
    """predict(lines) -> mean = len(line), std = 1; raises on 'bad'."""

    def predict(self, lines):
        if any("bad" in ln for ln in lines):
            raise ValueError("malformed line")
        return (np.asarray([float(len(ln)) for ln in lines]),
                np.ones(len(lines)))


def _client(host, port, lines, timeout=60.0):
    with socket.create_connection((host, port), timeout=timeout) as sk:
        f = sk.makefile("rwb")
        f.write("".join(ln + "\n" for ln in lines).encode())
        f.flush()
        sk.shutdown(socket.SHUT_WR)
        return [json.loads(raw.decode()) for raw in f]


def test_socket_server_batches_across_clients_and_isolates_bad_lines():
    with EstimatorSocketServer(_StubEstimator(), port=0,
                               quiet_gap_ms=5.0) as srv:
        per_client = [[f"q{c}_{i}" + "x" * c for i in range(40)]
                      for c in range(6)]
        results = [None] * 6

        def run(c):
            results[c] = _client(srv.host, srv.port, per_client[c])

        threads = [threading.Thread(target=run, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        bad = _client(srv.host, srv.port, ["good_1", "this_is_bad", "good_2"])
        st = srv.stats()
    for c in range(6):
        assert [r["mean"] for r in results[c]] == \
            [float(len(ln)) for ln in per_client[c]]
        assert all(r["std"] == 1.0 for r in results[c])
    assert st["requests"] == 242 and st["batches"] < 240
    assert bad[0]["mean"] == 6.0 and bad[2]["mean"] == 6.0
    assert "ValueError" in bad[1]["error"]


def test_socket_server_real_estimator_with_intervals(toy):
    est = _estimator(toy)
    est.calibrate_uncertainty(
        [f"ta,tb@x,{u:.3f},{u - 2:.3f}@@ta,tb,id@1800"
         for u in np.linspace(-6, 6, 25)], verbose=False)
    queries = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id"]
    with EstimatorSocketServer(est, port=0, alpha=0.2) as srv:
        out = _client(srv.host, srv.port, queries + ["\\stats"])
    mean, std = est.predict(queries)
    for resp, m, s in zip(out, mean, std):
        assert resp["mean"] == pytest.approx(m, rel=1e-12)
        assert resp["std"] == pytest.approx(s, rel=1e-12)
        assert resp["lo"] <= resp["mean"] <= resp["hi"]
        assert resp["card_lo"] <= resp["card"] <= resp["card_hi"]
    # \stats is answered in order, with the metrics as it was read
    assert "qps" in out[2] and "feedback_lines" not in out[2]


def test_is_labeled_grammar_split():
    assert _is_labeled("ta,tb@x,5.0,1.0@@ta,tb,id@1234")
    assert _is_labeled("t@x,5.0,1.0@77")
    assert not _is_labeled("ta,tb@x,5.0,1.0@@ta,tb,id")
    assert not _is_labeled("t@x,5.0,1.0")
    assert not _is_labeled("t@x,5.0,1.0@")


def _wait(cond, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)


@pytest.mark.parametrize("mode", ["online", "monitor"])
def test_feedback_over_the_wire(toy, mode):
    """Labeled lines are acked at once and reach the drift monitor; in
    'online' mode they also extend the posterior. A malformed labeled
    line costs only itself; card-less lines keep serving."""
    est = _estimator(toy)
    n0 = est.posterior.num_train
    rng = np.random.default_rng(3)
    labeled = _lines(rng, 20, labeled=True)
    bad = "ta,tb@zz,5.0,1.0@@ta,tb,id@125"
    queries = _lines(rng, 5)
    with EstimatorSocketServer(est, port=0, feedback_mode=mode,
                               feedback_batch=16,
                               feedback_flush_s=0.2) as srv:
        replies = _client(srv.host, srv.port,
                          labeled[:10] + [bad] + labeled[10:] + queries)
        _wait(lambda: srv.stats()["feedback_lines"] >= 20)
        st = srv.stats()
    assert replies[:21] == [{"feedback": "queued", "mode": mode}] * 21
    assert all("mean" in r for r in replies[21:])
    assert st["feedback_lines"] == 20 and st["feedback_errors"] == 1
    assert est.drift_monitor.n == 20
    if mode == "online":
        assert est.posterior.num_train == n0 + 20 and st["extends"] >= 1
    else:
        assert est.posterior.num_train == n0 and st["extends"] == 0


def test_feedback_auto_waits_for_hyperopt():
    """feedback_mode='auto' is served, and so is the Nystrom tier's
    train_log (a list of lines, or a query directory read at the first
    growth; the remediation itself is in test_torch_nystrom_serve.py)."""
    with EstimatorSocketServer(_StubEstimator(), port=0,
                               feedback_mode="auto") as srv:
        st = srv.stats()
    assert st["remediations"] == st["remediations_skipped"] == 0
    with EstimatorSocketServer(_StubEstimator(), port=0, feedback_mode="auto",
                               train_log=("t@x,1,0@5",)) as srv:
        assert srv.train_log == ["t@x,1,0@5"]
        assert srv._resolve_train_log() == ["t@x,1,0@5"]
    with pytest.raises(ValueError, match="feedback_mode must be"):
        EstimatorSocketServer(_StubEstimator(), port=0,
                              feedback_mode="sometimes")


def test_feedback_auto_relearns_on_a_drift_alarm(toy):
    """'auto': labeled lines extend the posterior; when the drift monitor
    alarms, the exact tier relearns its hyperparameters (warm, on the
    posterior's own rows), the monitor resets, and the conformal scores
    of a calibrated estimator are refreshed on the next batch before it is
    folded in."""
    est = _estimator(toy)
    est.calibrate_uncertainty(_lines(np.random.default_rng(8), 30,
                                     labeled=True), verbose=False)
    rng = np.random.default_rng(9)
    calm = _lines(rng, 140, labeled=True)
    drifted = _lines(rng, 60, labeled=True, scale=4.0)
    after = _lines(rng, 20, labeled=True)
    n0 = est.posterior.num_train
    with EstimatorSocketServer(est, port=0, feedback_mode="auto",
                               feedback_batch=400,
                               feedback_flush_s=0.3) as srv:
        _client(srv.host, srv.port, calm)
        _wait(lambda: srv.stats()["feedback_lines"] >= 140)
        scores = est._conformal_scores
        _client(srv.host, srv.port, drifted)
        _wait(lambda: srv.stats()["remediations"] >= 1, 120.0)
        _client(srv.host, srv.port, after)
        _wait(lambda: srv.stats()["feedback_lines"] >= 220)
        st = srv.stats()
    assert st["drift_alarms"] == st["remediations"] >= 1
    assert st["remediations_skipped"] == st["feedback_errors"] == 0
    assert est.hyper_result is not None
    assert est.spec.layers[0].b_std == est.hyper_result.b > 0
    assert est.posterior.num_train == n0 + 220
    assert est.drift_monitor.n <= 80        # reset at the alarm
    assert est._conformal_scores is not scores


# ------------------------------------------------------ drift and feedback
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_monitor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(delta=0.1, threshold=8.0, warmup=32)
    mon, jmon = drift.DriftMonitor(**kw), jax_drift.DriftMonitor(**kw)
    for shift in (0.0, 0.0, 0.3, 1.0):
        z = np.abs(rng.standard_normal(40)) + shift
        z[3] = np.nan
        assert mon.update(z) == jmon.update(z)
        assert (mon.n, mon.stat, mon.drift) == (jmon.n, jmon.stat,
                                                jmon.drift)
    mon.reset()
    jmon.reset()
    assert (mon.n, mon.stat, mon.drift) == (jmon.n, jmon.stat, jmon.drift)
    assert drift.DriftReport.__dataclass_fields__.keys() == \
        jax_drift.DriftReport.__dataclass_fields__.keys()


def test_feedback_merge_matches_jax(tmp_path):
    card_csv = tmp_path / "card.csv"
    card_csv.write_text(
        "query;nngp_card;nngp_std;pg_card;mix_card;true_card\n"
        "q1;200.0;2.0;1.0;0;100\n"
        "q2;0;1.0;1.0;0;5\n"
        "q3;50.0;1.0;1.0;0;-1\n"
        "q4;1.0;0.5;1.0;0;0\n")
    sub = tmp_path / "sub.txt"
    sub.write_text("ta,tb@x,1,0@@ta,tb,id@100\n"
                   "ta,tb@x,2,0@@ta,tb,id@400\n"
                   "ta,tb@x,3,0@@ta,tb,id@0\n")
    got = feedback.build_aux_file(str(card_csv), str(sub),
                                  str(tmp_path / "aux.txt"))
    want = jax_feedback.build_aux_file(str(card_csv), str(sub),
                                       str(tmp_path / "jax_aux.txt"))
    assert got == want and len(got) == 3
    assert (tmp_path / "aux.txt").read_text() == \
        (tmp_path / "jax_aux.txt").read_text()
    infos = feedback.load_card_csv(str(card_csv))
    assert [tuple(i) for i in infos] == \
        [tuple(i) for i in jax_feedback.load_card_csv(str(card_csv))]
    bad = [feedback.PredInfo("q", 10.0, 1.0, 1.0, 7.0)]
    with pytest.raises(ValueError, match="Inconsistent true card"):
        feedback.merge_query_res(bad, ["ta@x,1,0@8\n"])


# --------------------------------------------------------- the serving demo
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_demo_cpu_with_checkpoint_streaming_and_listen(toy, tmp_path,
                                                             capsys):
    from nngp_tpu_torch.cli import serve_demo

    stats, qdir = toy
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    for i, s in enumerate(stats):
        s.save(str(stats_dir / f"{i}_{s.table_name}.json"))
    test_file = tmp_path / "test.txt"
    test_file.write_text("\n".join(_lines(np.random.default_rng(5), 30,
                                          labeled=True)) + "\n")
    cal_file = tmp_path / "cal.txt"
    cal_file.write_text("\n".join(_lines(np.random.default_rng(6), 30,
                                         labeled=True)) + "\n")
    ckpt = tmp_path / "ckpt"
    base = ["--device", "cpu", "--schema_name", "toy", "--stats_dir",
            str(stats_dir), "--train_query_path", qdir, "--ckpt", str(ckpt)]
    serve_demo.main(base + ["--test_query_file", str(test_file),
                            "--streaming", "--stream_clients", "3",
                            "--calibrate_file", str(cal_file)])
    out = capsys.readouterr().out
    assert "loading schema" in out and "predicted 30 queries" in out
    assert "streamed 90 requests" in out and "conformal 90%" in out
    assert (ckpt / "meta.json").exists()

    port = _free_port()
    replies = []

    def client():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                replies.extend(_client("127.0.0.1", port,
                                       _lines(np.random.default_rng(7), 3)))
                return
            except OSError:
                time.sleep(0.05)

    t = threading.Thread(target=client)
    t.start()
    serve_demo.main(base + ["--listen", f"127.0.0.1:{port}",
                            "--listen_max_requests", "3",
                            "--warmup_batch", "16"])
    t.join(timeout=60)
    out = capsys.readouterr().out
    assert "restoring from checkpoint" in out
    assert "served 3 requests" in out
    assert len(replies) == 3 and all("mean" in r for r in replies)


def test_serve_demo_learns_and_reuses_a_hyper_file(toy, tmp_path, capsys):
    """--learn_hyper --ard --hyper_file learns, saves the artifact and
    serves; a second run serves with the artifact without learning, and
    predicts the same."""
    from nngp_tpu_torch.cli import serve_demo

    stats, qdir = toy
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    for i, s in enumerate(stats):
        s.save(str(stats_dir / f"{i}_{s.table_name}.json"))
    test_file = tmp_path / "test.txt"
    test_file.write_text("\n".join(_lines(np.random.default_rng(5), 10,
                                          labeled=True)) + "\n")
    hyper = tmp_path / "hyper.json"
    argv = ["--device", "cpu", "--schema_name", "toy", "--stats_dir",
            str(stats_dir), "--train_query_path", qdir, "--test_query_file",
            str(test_file), "--hyper_file", str(hyper), "--hyper_steps",
            "4", "--hyper_points", "40"]
    serve_demo.main(argv + ["--learn_hyper", "--ard"])
    first = capsys.readouterr().out
    serve_demo.main(argv)
    second = capsys.readouterr().out
    assert "learned hyperparameters" in first
    assert "saved hyperparameter artifact" in first and hyper.exists()
    assert f"serving with hyperparameters from {hyper}" in second
    assert "learned hyperparameters" not in second

    def first5(out):
        return out.split("first 5")[1].split("\n")[1:6]

    assert first5(first) == first5(second)


@pytest.mark.parametrize("flags,m", [
    (["--nystrom_m", "24"], 24),
    (["--nystrom_m", "24", "--nystrom_moments", "df64"], 24),
    (["--tier", "nystrom"], 60),
], ids=["m", "df64", "tier"])
def test_serve_demo_nystrom_flags(toy, tmp_path, capsys, flags, m):
    """The demo's Nystrom flags (once refused, now ported) serve from the
    Nystrom tier, and its checkpoint restores on a second run with the
    same answers."""
    from nngp_tpu_torch.cli import serve_demo

    stats, qdir = toy
    stats_dir = tmp_path / "stats"
    stats_dir.mkdir()
    for i, s in enumerate(stats):
        s.save(str(stats_dir / f"{i}_{s.table_name}.json"))
    test_file = tmp_path / "test.txt"
    test_file.write_text("\n".join(_lines(np.random.default_rng(5), 10,
                                          labeled=True)) + "\n")
    argv = ["--device", "cpu", "--schema_name", "toy", "--stats_dir",
            str(stats_dir), "--train_query_path", qdir, "--test_query_file",
            str(test_file), "--ckpt", str(tmp_path / "ck"), *flags]
    serve_demo.main(argv)
    first = capsys.readouterr().out
    serve_demo.main(argv)
    second = capsys.readouterr().out
    assert "predicted 10 queries" in first and "restoring" in second
    with open(tmp_path / "ck" / "meta.json") as f:
        meta = json.load(f)
    assert meta["nystrom"]["moments"] == (
        "df64" if "df64" in flags else "fp32")
    with np.load(tmp_path / "ck" / "posterior.npz") as arrs:
        assert arrs["x_m"].shape[0] == m
    first5 = [l.split()[:2] for l in
              first.split("first 5")[1].split("\n")[1:6]]
    again = [l.split()[:2] for l in
             second.split("first 5")[1].split("\n")[1:6]]
    np.testing.assert_allclose(np.asarray(again, float),
                               np.asarray(first5, float), atol=2e-3)


@pytest.mark.parametrize("flags,item", [
    (["--mesh_devices", "4"], "world size is 1"),
    (["--pad_slots", "8", "--nystrom_m", "16"],
     "--pad_slots pads the single-device exact posterior"),
    (["--tier", "distributed"], "needs --mesh_devices"),
])
def test_serve_demo_unported_flags_name_their_item(flags, item, capsys):
    """Flags that cannot run stop with a usage error: --pad_slots pads the
    single-device exact tier only; --mesh_devices must be the world size
    (1 without a launcher), and --tier distributed needs a mesh."""
    from nngp_tpu_torch.cli import serve_demo

    with pytest.raises(SystemExit) as exc:
        serve_demo.main(["--device", "cpu", "--schema_name", "toy",
                         "--train_query_path", "q", "--test_query_file",
                         "t", *flags])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


_BLOCK_HOOK = """
import importlib.abc
import sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pandas",
                                  "nngp_tpu"):
            raise ImportError(f"blocked {name}")
        return None


sys.meta_path.insert(0, _Block())
"""


def test_serving_imports_and_runs_with_jax_and_pandas_blocked(tmp_path):
    """A fresh interpreter in which importing jax, pandas or the JAX
    package `nngp_tpu` raises: every module of the port imports (the
    distributed tier `nngp_tpu_torch.parallel` too); a short learn, a
    world-size-1 distributed fit and predict and the active-learning CLI
    run, the demo serves the committed synth workload on the CPU (both
    CLIs over a one-rank mesh, --mesh_devices 1), and the offline data
    CLIs label and clean tiny raw tpch tables."""
    from tests.test_loader_onramp import _make_schema_csvs

    raw = tmp_path / "raw"
    raw.mkdir()
    _make_schema_csvs("tpch", raw)
    labeled, cleaned = str(tmp_path / "labeled"), str(tmp_path / "cleaned")
    code = _BLOCK_HOOK + (
        "import importlib, pkgutil\n"
        "import numpy as np\n"
        "import nngp_tpu_torch\n"
        "for mod in pkgutil.walk_packages(nngp_tpu_torch.__path__,\n"
        "                                 'nngp_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import nngp_tpu_torch.serve\n"
        "import nngp_tpu_torch.cli.serve_demo as demo\n"
        "import nngp_tpu_torch.active\n"
        "from nngp_tpu_torch.cli import active_train\n"
        "from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams\n"
        "rng = np.random.default_rng(0)\n"
        "res = fit_kernel_hyperparams(rng.uniform(0, 1, (40, 3)),\n"
        "                             rng.normal(size=40), steps=3,\n"
        "                             ard=True, device='cpu')\n"
        "assert np.isfinite(res.log_evidence)\n"
        "from nngp_tpu_torch.gp import fit_nystrom\n"
        "ny = fit_nystrom(res.spec,\n"
        "                 rng.uniform(0, 1, (40, 3)).astype(np.float32),\n"
        "                 rng.normal(size=40), num_inducing=8,\n"
        "                 moments='df64', device='cpu')\n"
        "ny = ny.extend(rng.uniform(0, 1, (4, 3)), rng.normal(size=4))\n"
        "assert np.isfinite(ny.log_evidence()) and ny.num_train == 44\n"
        "import nngp_tpu_torch.parallel as par\n"
        "mesh = par.make_mesh(1, device='cpu')\n"
        "dpost = par.distributed_fit(res.spec, rng.uniform(0, 1, (37, 3)),\n"
        "                            rng.normal(size=37), mesh,\n"
        "                            block_size=8)\n"
        "dmean, dstd = dpost.predict_mean_std(rng.uniform(0, 1, (5, 3)))\n"
        "assert dpost.num_padded == 40 and dpost.num_train == 37\n"
        "assert np.isfinite(dmean.numpy()).all() and (dstd >= 0).all()\n"
        "hist = active_train.main(['--device', 'cpu', '--schema_name',\n"
        "    'synth', '--query_path', 'workloads/synth_join_data',\n"
        "    '--budget', '20', '--active_iters', '1', '--selection',\n"
        "    'greedy', '--mesh_devices', '1'])\n"
        "assert hist[0]['num_train'] == 500, hist\n"
        "demo.main(['--device', 'cpu', '--schema_name', 'synth',\n"
        "           '--stats_dir', 'workloads/synth_stats',\n"
        "           '--train_query_path', 'workloads/synth_join_data',\n"
        "           '--test_query_file',\n"
        "           'workloads/synth_join_data/join_query_2.txt',\n"
        "           '--limit', '50', '--mesh_devices', '1', '--tier',\n"
        "           'distributed'])\n"
        "from nngp_tpu_torch.cli import clean_schema, sample_queries\n"
        "sample_queries.main(['--schema_name', 'tpch', '--data_path',\n"
        f"    {str(raw)!r}, '--save_path', {labeled!r}, '--mini_batch',\n"
        "    '5', '--data_centric'])\n"
        "clean_schema.main(['--schema_name', 'tpch', '--data_path',\n"
        f"    {str(raw)!r}, '--out_dir', {cleaned!r}, '--int_cast'])\n"
        "loaded = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas',\n"
        "                      'nngp_tpu') "
        "if m in sys.modules]\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "predicted 50 queries" in proc.stdout
    assert "LOADED []" in proc.stdout
    for k in range(1, 5):
        with open(os.path.join(labeled, f"join_query_{k}.txt")) as f:
            assert len(f.read().split()) == 5
    assert sorted(os.listdir(cleaned)) == ["lineitem.csv", "orders.csv",
                                           "part.csv", "supplier.csv"]


def test_no_mesh_surface_raises_as_unported():
    """No 'Queue A #12' (the parallel/ item) and no 'Queue A #14' (the
    front ends at world size > 1, served through serve/follower.py) is
    left in the port."""
    hits = {"Queue A #12": [], "Queue A #14": []}
    pkg = os.path.join(REPO, "nngp_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    text = f.read()
                for key in hits:
                    if key in text:
                        hits[key].append(os.path.relpath(path, pkg))
    assert hits["Queue A #12"] == []
    assert hits["Queue A #14"] == []
