"""The port's span recorder (`nngp_tpu_torch/utils/profiling.py`: `span`,
`current`, `enable`, `disable`, `take`) and the spans the serving path and
the Nystrom fit record with it, on the CPU: nothing kept or allocated
while the recorder is off; one `batcher.capture`, `batcher.predict` and
`batcher.finish` a batch under one id, with the `estimator.*` and
`graphs.*` spans nested under its predict; memo and duplicate hits; the
capture's wake and reason; a bisection's retries; the pipelined mode's
dispatch and fetch; separate parent stacks per thread; the fit's
prepare, bases, panels and finalize, and its cached bases; a full buffer's
drops. The card-only spans (`graphs.copy_in`, `graphs.replay`,
`graphs.copy_out`, `graphs.capture`) run where the buckets are CUDA
graphs, which the CPU does not have."""

import math
import sys
import threading

import numpy as np
import pytest

from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.gp import nystrom as TN
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.serve import Estimator
from nngp_tpu_torch.serve.streaming import StreamingBatcher
from nngp_tpu_torch.utils import profiling
from tests.test_active_serve import _toy_schema_files


@pytest.fixture(scope="module")
def est(tmp_path_factory):
    stats, qdir = _toy_schema_files(tmp_path_factory.mktemp("toy"))
    return Estimator("toy", None, qdir, stats=stats, dtype=np.float64,
                     verbose=False, device="cpu")


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        out.append(f"ta,tb@x,{xu:.4f},{xl:.4f}@@ta,tb,id")
    return out


def _recorded(fn):
    """(fn's result, spans, dropped) with the recorder on around fn."""
    profiling.take()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    spans, dropped = profiling.take()
    return out, spans, dropped


def _served(est, lines, **kw):
    """Serve `lines` through a batcher over est.predict; returns the
    dispatcher thread's ident and the answers."""
    with StreamingBatcher(est.predict, max_wait_ms=20.0, **kw) as b:
        out = b.predict(lines)
        thread = b._thread.ident
    return thread, out


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _fit(x, y):
    return fit_nystrom(KernelSpec(mlp(1, width=64)), x, y, num_inducing=16,
                       panel_size=40, device="cpu")


def _fit_data(seed, n=150):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1000, (n, 12)).astype(np.float64),
            rng.uniform(0.0, 16.0, (n, 1)))


def test_off_span_and_current_are_the_shared_no_op():
    assert profiling.span("x", rows=3) is profiling.NO_SPAN
    assert profiling.current() is profiling.NO_SPAN
    with profiling.span("x") as s:
        s.set(rows=1)
        s.add("attempts")
        assert s is profiling.NO_SPAN
    assert profiling.take() == ([], 0)


def test_off_a_served_run_and_a_fit_keep_and_allocate_no_span(
        est, monkeypatch):
    made = []
    init = profiling.Span.__init__

    def counting(self, name, attrs):
        made.append(name)
        init(self, name, attrs)

    monkeypatch.setattr(profiling.Span, "__init__", counting)
    profiling.take()
    lines = _lines(30, 1)
    _, (mean, _) = _served(est, lines + lines[:5])
    x, y = _fit_data(1)
    _fit(x, y)
    assert mean.shape == (35,)
    assert made == [] and profiling.take() == ([], 0)


def test_each_batch_gives_one_capture_predict_and_finish(est):
    lines = _lines(40, 2)
    (thread, (mean, _)), spans, dropped = _recorded(
        lambda: _served(est, lines))
    assert dropped == 0 and mean.shape == (40,)
    by = {name: _named(spans, name) for name in
          ("batcher.capture", "batcher.predict", "batcher.finish")}
    ids = [s.attrs["batch"] for s in by["batcher.capture"]]
    assert ids and len(set(ids)) == len(ids)
    for name, group in by.items():
        assert sorted(s.attrs["batch"] for s in group) == sorted(ids), name
        for s in group:
            assert s.thread == thread and s.parent == 0 and s.t1 >= s.t0
    rows = {s.attrs["batch"]: s.attrs["rows"] for s in by["batcher.capture"]}
    assert sum(rows.values()) == 40
    for name in ("batcher.predict", "batcher.finish"):
        assert {s.attrs["batch"]: s.attrs["rows"] for s in by[name]} == rows
    for s in by["batcher.capture"]:
        assert s.attrs["reason"] in ("quiet", "deadline", "full", "backlog")
        assert s.attrs["wake"] in ("idle", "backlog")
        assert s.attrs["sleeps"] >= 0
    assert all(s.attrs["retry"] is False for s in by["batcher.predict"])
    assert all(s.thread == thread for s in _named(spans, "batcher.wait"))


def test_estimator_and_graphs_spans_nest_under_the_batch(est):
    lines = _lines(50, 3)
    (thread, _), spans, _ = _recorded(lambda: _served(est, lines))
    by_id = {s.id: s for s in spans}
    predicts = _named(spans, "estimator.predict")
    assert predicts
    for s in predicts:
        parent = by_id[s.parent]
        assert parent.name == "batcher.predict" and s.thread == thread
        assert s.attrs["lines"] == parent.attrs["rows"]
        assert s.attrs["rows"] == s.attrs["lines"] - s.attrs["memo_hits"] \
            - s.attrs["dup_hits"]
    inner = {"estimator.memo", "estimator.encode", "estimator.assemble",
             "graphs.run"}
    for s in spans:
        if s.name in inner:
            assert by_id[s.parent].name == "estimator.predict", s.name
    for s in _named(spans, "estimator.encode"):
        assert s.attrs["rows"] == by_id[s.parent].attrs["rows"]
    runs = _named(spans, "graphs.run")
    assert runs and sum(s.attrs["rows"] for s in runs) == sum(
        s.attrs["rows"] for s in predicts)
    for s in runs:
        assert 0 < s.attrs["rows"] <= s.attrs["bucket"]
        assert s.attrs["bucket"] & (s.attrs["bucket"] - 1) == 0


def test_a_repeated_line_shows_in_memo_or_dup_hits(est):
    known, fresh = _lines(6, 4), _lines(10, 5)
    est.predict(known)                       # into the memo
    batch = known + fresh + fresh[:3]
    _, spans, _ = _recorded(lambda: est.predict(batch))
    (s,) = _named(spans, "estimator.predict")
    assert s.attrs == {"lines": 19, "memo_hits": 6, "dup_hits": 3,
                       "rows": 10}
    (enc,) = _named(spans, "estimator.encode")
    assert enc.attrs["rows"] == 10 and enc.parent == s.id
    _, spans, _ = _recorded(lambda: est.predict(known))
    (s,) = _named(spans, "estimator.predict")
    assert s.attrs["memo_hits"] == 6 and s.attrs["rows"] == 0
    assert _named(spans, "estimator.encode") == []
    assert _named(spans, "graphs.run") == []


def test_a_capture_names_its_wake_and_reason():
    entered, release = threading.Event(), threading.Event()

    def predict(items):
        if not entered.is_set():
            entered.set()
            release.wait(timeout=30)
        return np.zeros(len(items)), np.ones(len(items))

    def run():
        with StreamingBatcher(predict, max_batch=8, max_wait_ms=25.0,
                              quiet_gap_ms=2.0) as b:
            first = b.submit("a")
            assert entered.wait(timeout=30)
            rest = [b.submit(str(i)) for i in range(20)]
            release.set()
            for f in [first] + rest:
                f.result(timeout=30)

    _, spans, _ = _recorded(run)
    caps = sorted(_named(spans, "batcher.capture"),
                  key=lambda s: s.attrs["batch"])
    assert [(s.attrs["wake"], s.attrs["reason"], s.attrs["rows"])
            for s in caps] == [("idle", "quiet", 1), ("backlog", "backlog", 8),
                               ("backlog", "backlog", 8),
                               ("backlog", "backlog", 4)]
    assert caps[0].attrs["sleeps"] >= 1 and caps[1].attrs["sleeps"] == 0


def test_a_bisection_marks_its_retries():
    def predict(items):
        if "bad" in items:
            raise ValueError("bad item")
        return np.zeros(len(items)), np.ones(len(items))

    def run():
        with StreamingBatcher(predict, max_wait_ms=25.0) as b:
            futs = [b.submit(x) for x in ("a", "b", "bad", "c")]
            for f in futs:
                f.exception(timeout=30)

    _, spans, _ = _recorded(run)
    predicts = _named(spans, "batcher.predict")
    first = [s for s in predicts if not s.attrs["retry"]]
    assert len(first) == len({s.attrs["batch"] for s in predicts})
    retries = [s for s in predicts if s.attrs["retry"]]
    assert retries and {s.attrs["batch"] for s in retries} <= {
        s.attrs["batch"] for s in first}
    finished = sum(s.attrs["rows"] for s in _named(spans, "batcher.finish"))
    assert finished == 3


def test_the_pipelined_mode_spans_dispatch_and_fetch():
    def run():
        with StreamingBatcher(dispatch_fn=lambda items: len(items),
                              fetch_fn=lambda k: (np.zeros(k), np.ones(k)),
                              max_wait_ms=5.0) as b:
            b.predict([str(i) for i in range(30)])

    _, spans, _ = _recorded(run)
    predicts = _named(spans, "batcher.predict")
    ids = sorted(s.attrs["batch"] for s in _named(spans, "batcher.capture"))
    for stage in ("dispatch", "fetch"):
        assert sorted(s.attrs["batch"] for s in predicts
                      if s.attrs["stage"] == stage) == ids
    assert sorted(s.attrs["batch"]
                  for s in _named(spans, "batcher.finish")) == ids


def test_threads_keep_separate_parent_stacks():
    barrier = threading.Barrier(2, timeout=30)
    outer = {}

    def work(tag):
        with profiling.span("outer", tag=tag) as o:
            outer[tag] = o.id
            barrier.wait()              # both outers open at once
            with profiling.span("inner", tag=tag):
                barrier.wait()
                with profiling.span("leaf", tag=tag) as leaf:
                    assert profiling.current() is leaf
            barrier.wait()

    def run():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    _, spans, _ = _recorded(run)
    by_id = {s.id: s for s in spans}
    assert len(spans) == 6
    for s in spans:
        if s.name == "outer":
            assert s.parent == 0 and outer[s.attrs["tag"]] == s.id
        else:
            parent = by_id[s.parent]
            assert parent.attrs["tag"] == s.attrs["tag"]
            assert parent.thread == s.thread
            assert parent.name == {"inner": "outer", "leaf": "inner"}[s.name]
    assert len({s.thread for s in spans}) == 2


def test_a_fit_spans_its_stages_and_panels(monkeypatch):
    monkeypatch.setattr(TN, "_BASES_CACHE", {})
    x, y = _fit_data(6)
    post, spans, dropped = _recorded(lambda: _fit(x, y))
    assert dropped == 0 and post.num_train == 150
    (fit,) = _named(spans, "nystrom.fit")
    assert fit.attrs == {"rows": 150, "panel": 40, "m": 16}
    children = [s for s in spans if s.parent == fit.id]
    assert [s.name for s in sorted(children, key=lambda s: s.t0)] == (
        ["nystrom.prepare", "nystrom.bases"]
        + ["nystrom.panel"] * math.ceil(150 / 40) + ["nystrom.finalize"])
    assert len(spans) == len(children) + 1
    assert [s.attrs["rows"] for s in _named(spans, "nystrom.panel")] == [
        40, 40, 40, 30]
    (bases,) = _named(spans, "nystrom.bases")
    assert bases.attrs["cached"] is False and bases.attrs["attempts"] >= 1
    assert _named(spans, "nystrom.finalize")[0].attrs == {"mode": "host"}
    assert _named(spans, "nystrom.prepare")[0].attrs == {
        "rows": 150, "probe": "device"}


def test_a_fit_given_its_input_scale_probes_nothing(monkeypatch):
    def no_probe(rows, layers):
        raise AssertionError("probed although input_scale was given")

    monkeypatch.setattr(TN, "_auto_input_scale", no_probe)
    monkeypatch.setattr(TN, "_BASES_CACHE", {})
    x, y = _fit_data(8)
    _, spans, _ = _recorded(lambda: fit_nystrom(
        KernelSpec(mlp(1, width=64)), x, y, num_inducing=16, panel_size=40,
        input_scale=4.0, device="cpu"))
    assert _named(spans, "nystrom.prepare")[0].attrs == {
        "rows": 150, "probe": "given"}


def test_a_second_fit_on_the_same_inducing_rows_finds_its_bases_cached(
        monkeypatch):
    monkeypatch.setattr(TN, "_BASES_CACHE", {})
    x, y = _fit_data(7)
    _fit(x, y)
    _, spans, _ = _recorded(lambda: _fit(x, y))
    (bases,) = _named(spans, "nystrom.bases")
    assert bases.attrs == {"cached": True}


def test_a_full_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "capacity", 3)

    def run():
        for i in range(5):
            with profiling.span("s", i=i):
                pass

    _, spans, dropped = _recorded(run)
    assert [s.attrs["i"] for s in spans] == [0, 1, 2] and dropped == 2
    assert profiling.take() == ([], 0)


def test_many_threads_lose_no_span_and_keep_their_parents(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "capacity", 3000)
    threads_n, each = 16, 250

    def work(tag):
        for i in range(each):
            with profiling.span("outer", tag=tag):
                with profiling.span("inner", tag=tag, i=i):
                    pass

    def run():
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)

    _, spans, dropped = _recorded(run)
    assert len(spans) == 3000 and dropped == 2 * threads_n * each - 3000
    assert len({s.id for s in spans}) == 3000
    outer = {s.id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner" and s.parent in outer:
            assert outer[s.parent].attrs["tag"] == s.attrs["tag"]
            assert outer[s.parent].thread == s.thread
        elif s.name == "outer":
            assert s.parent == 0
