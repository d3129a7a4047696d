"""Closed planner sessions against the serving path.

The system under test: `serve.Estimator` (the configuration's tier,
dtype, and its `estimator` keywords: pad slots, memo) behind
`serve.StreamingBatcher` at the mix's settings. Each of the mix's
sessions sends a planning request of k sub-query lines through the
batcher and waits for every estimate before it sends the next, with no
think time. One thread drives every session
(load from one thread, not one a session: 32 client threads contending
for the interpreter made the batches' formation, and so the rate, swing
from run to run). k comes from a fixed multiset (log-uniform integers on
[lines_min, lines_max], one per quantile), the same for every seed, in an
order the seed draws per session; each session walks its own stretch of a
seeded permutation of the line pool: the mix's lines outside the
configuration's own (no served line is a train line).

End-to-end readings: estimates_per_s, the estimates of the requests
completed within the window over its seconds; request_p95_ms, the 95th
percentile over every request sent in the window, send to last estimate.

The control (`control`): the configuration's `control` `config` keys,
the program's own path in the next precision down.
"""

import contextlib
import io
import math
import os
import time
from types import SimpleNamespace

import numpy as np

from portbench.lib import data, registry
from portbench.lib.devtrace import TRACE_ATTEMPTS, Session, Spans, \
    no_activity
from portbench.reference import encoder as ref_encoder
from portbench.reference import judge
from portbench.tiers import kernel_spec


def size_multiset(lo, hi, count):
    """`count` log-uniform integers on [lo, hi], one at each quantile."""
    u = (np.arange(count) + 0.5) / count
    return np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1)
                                              - math.log(lo)))).astype(int)


class _Tracer:
    """The traced sub-window of a served run, stepped from the thread that
    drives the sessions (the profiler's own): a session begins
    traced_seconds / 2 + 0.3 s before the window's middle, its traced
    step starts 0.3 s later and lasts traced_seconds; a session that
    recorded no device activity is tried again, up to TRACE_ATTEMPTS."""

    def __init__(self, run, seconds, traced_seconds):
        self.run, self.traced = run, None
        self.span = min(traced_seconds, 0.5 * seconds)
        self.next_at = 0.5 * (seconds - self.span) - 0.3 if run.trace \
            else None
        self.session, self.phase, self.attempt = None, 0, 0

    def tick(self, now):
        import torch

        if self.next_at is None or now < self.next_at:
            return
        if self.phase == 0:
            self.session = Session(torch, self.run.tmp_dir)
            self.session.begin()
            self.phase, self.next_at = 1, now + 0.3
        elif self.phase == 1:
            self.session.activate()
            self.phase, self.next_at = 2, now + self.span
        else:
            self.session.stop()
            self.traced = self.session.read()
            self.session, self.phase = None, 0
            self.attempt += 1
            if self.traced is not None or self.attempt >= TRACE_ATTEMPTS:
                self.next_at = None
            else:
                no_activity(self.attempt - 1)

    def result(self):
        """The Traced, after stopping a step the window's end cut short."""
        if self.phase == 2:
            self.session.stop()
            self.traced = self.session.read()
            self.attempt += 1
        elif self.phase == 1:
            self.session.stop()
        self.session = None
        if self.run.trace and self.traced is None:
            raise RuntimeError("no traced sub-window with device activity "
                               f"in {self.attempt} sessions")
        return self.traced


class Runner:
    IDLE_OUTSIDE = "batcher_wait"

    def __init__(self, run):
        self.run = run
        self.cfg, self.mix = run.config, run.mix

    # ------------------------------------------------------------ set-up
    def setup(self):
        import torch

        cfg, mix, run = self.cfg, self.mix, self.run
        queries = data.read_lines(run.root, cfg["queries"])
        ordered = data.split_order(queries, cfg["split_seed"])
        self.train = ordered[:cfg["train_rows"]]
        exclude = set(queries)
        pool = [data.strip_card(l) for l in
                data.read_lines(run.root, mix["pool"]) if l not in exclude]
        rng = np.random.default_rng([run.seed, 1])
        self.pool = [pool[i] for i in rng.permutation(len(pool))]
        sizes = size_multiset(mix["lines_min"], mix["lines_max"],
                              mix["size_quantiles"])
        self.sizes = [rng.permutation(sizes) for _ in
                      range(mix["sessions"])]
        self.spans = Spans() if run.trace else None
        self.tracer = None
        self.counts = {"memo_or_dedup_hits": 0, "rows_encoded": 0,
                       "predict_calls": 0}
        if run.program is not None:
            self.est = run.program(self)
        else:
            self.est = self.program_estimator()
        self._count_encode()
        from nngp_tpu_torch.serve import StreamingBatcher

        self.batcher = StreamingBatcher(
            self._predict_fn, max_batch=mix["max_batch"],
            max_wait_ms=mix["max_wait_ms"],
            quiet_gap_ms=mix["quiet_gap_ms"])
        # the host path once, on lines the window sends later
        self.batcher.predict(self.pool[-mix["lines_min"]:])
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def program_estimator(self):
        """The system under test: the Estimator fitted on the train lines,
        its buckets warmed for the mix's largest batch."""
        from nngp_tpu_torch.serve import Estimator

        cfg, run = self.cfg, self.run
        train_dir = os.path.join(run.tmp_dir,
                                 f"portbench_train_{os.getpid()}")
        os.makedirs(train_dir, exist_ok=True)
        with open(os.path.join(train_dir, "join_query_train.txt"), "w") as f:
            f.write("\n".join(self.train) + "\n")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                est = Estimator(
                    cfg["schema"], None, train_dir,
                    stats_dir=data.checked_dir(run.root, cfg["stats"]),
                    spec=kernel_spec(cfg), kernel_type=cfg["get"],
                    diag_reg=cfg["diag_reg"], dtype=np.dtype(cfg["dtype"]),
                    chunk_norm=cfg["chunk_norm"], tier=cfg["tier"],
                    device=str(run.device), **cfg.get("estimator", {}))
                buckets = est.warmup(max_batch=self.mix["max_batch"])
        finally:
            os.remove(os.path.join(train_dir, "join_query_train.txt"))
            os.rmdir(train_dir)
        run.log(f"encoder {est.encoder_kind}, buckets warmed {buckets}")
        post = est.posterior
        self.counts["storage_rows"] = int(getattr(post, "num_padded",
                                                  post.num_train))
        self.counts["train_rows"] = int(post.num_train)
        self.counts["feature_dim"] = int(
            getattr(post, "x_train", getattr(post, "x_m", None)).shape[1])
        return est

    def _count_encode(self):
        """Count the rows that reach the device (and with --trace 1 span
        the encode) around this instance's encode_lines."""
        inner, spans, counts = self.est.encode_lines, self.spans, self.counts

        def encode_lines(lines):
            t0 = time.perf_counter()
            x = inner(lines)
            if spans is not None:
                spans.add("encode", t0, time.perf_counter(), rows=len(lines))
            counts["rows_encoded"] += len(lines)
            return x

        self.est.encode_lines = encode_lines

    def _predict_fn(self, lines):
        session = self.tracer.session if self.tracer is not None else None
        if session is not None:
            session.mark()                 # the last batch has finished
        t0 = time.perf_counter()
        out = self.est.predict(lines)
        self.counts["predict_calls"] += 1
        if self.spans is not None:
            self.spans.add("predict_fn", t0, time.perf_counter(),
                           lines=len(lines))
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds):
        """The sessions, all driven by this one thread: each request's
        lines are submitted to the batcher at once, and when a batch has
        answered a request (its last future resolved: the batcher answers
        in submission order) its session sends the next, until the
        window closes; requests in flight then finish."""
        mix, pool = self.mix, self.pool
        n_sessions = mix["sessions"]
        stretch = len(pool) // n_sessions
        cursor = [s * stretch for s in range(n_sessions)]
        sent_of = [0] * n_sessions
        records, failed, pending = [], [0], {}

        def send(s):
            k = int(self.sizes[s][sent_of[s] % len(self.sizes[s])])
            lines = [pool[(cursor[s] + j) % len(pool)] for j in range(k)]
            t_send = time.perf_counter()
            pending[s] = (t_send, cursor[s], k,
                          [self.batcher.submit(l) for l in lines])
            cursor[s] += k
            sent_of[s] += 1

        def collect(s, t_done):
            t_send, at, k, futs = pending.pop(s)
            try:
                out = np.asarray([f.result() for f in futs])
                mean, std = out[:, 0], out[:, 1]
            except Exception as e:            # a request that never comes
                failed[0] += 1
                self.run.log(f"session {s}: request failed: {e!r}")
                mean = std = None
            records.append((t_send, t_done, at, k, mean, std))

        hits0 = self.counts["rows_encoded"]
        tracer = self.tracer = _Tracer(self.run, seconds,
                                       mix["traced_seconds"])
        t0 = time.perf_counter()
        t_end = t0 + seconds
        for s in range(n_sessions):
            send(s)
        while pending:
            oldest = min(pending, key=lambda s: pending[s][0])
            try:
                pending[oldest][3][-1].result(timeout=600.0)
            except Exception:                 # collect() counts it
                pass
            t_done = time.perf_counter()
            answered = sorted(s for s in pending if pending[s][3][-1].done())
            for s in answered:
                collect(s, t_done)
            if t_done < t_end:
                for s in answered:
                    send(s)
            tracer.tick(t_done - t0)
        traced = tracer.result()
        reqs = self.records = records
        lat = np.asarray([(r[1] - r[0]) * 1e3 for r in reqs])
        done = sum(r[3] for r in reqs if r[1] <= t_end and r[4] is not None)
        ks = np.asarray([r[3] for r in reqs])
        sent = int(ks.sum())
        self.counts.update({
            "requests": len(reqs), "lines_sent": sent,
            "request_lines_p5_p50_p95_mean": [
                float(np.percentile(ks, 5)), float(np.percentile(ks, 50)),
                float(np.percentile(ks, 95)), float(ks.mean())],
            "rows_encoded_window": self.counts["rows_encoded"] - hits0,
            "latency_ms_p50_p95_p99": [float(np.percentile(lat, q))
                                       for q in (50, 95, 99)]})
        self.counts["memo_or_dedup_hits"] = (
            sent - self.counts["rows_encoded_window"])
        return SimpleNamespace(
            e2e={"estimates_per_s": done / seconds,
                 "request_p95_ms": float(np.percentile(lat, 95))},
            counts=self.counts, spans=self.spans, traced=traced,
            attempted=len(reqs), failed=failed[0])

    def release(self):
        self.batcher.close()
        self.batcher = self.est = None

    # ------------------------------------------------------------- check
    def judge(self):
        """The served answers of a seeded sample of the window's
        requests' lines against the tier's reference posterior
        (`reference/<tier>.py`) in fp64, worked out from the lines."""
        import torch

        cfg, run = self.cfg, self.run
        answered = [r for r in self.records if r[4] is not None]
        rng = np.random.default_rng([run.seed, 2])
        flat = np.asarray([(i, j) for i, r in enumerate(answered)
                           for j in range(r[3])])
        pick = flat[rng.choice(len(flat), size=min(cfg["check_answers"],
                                                   len(flat)),
                               replace=False)]
        lines, mean, std = [], [], []
        for i, j in pick:
            r = answered[i]
            lines.append(self.pool[(r[2] + j) % len(self.pool)])
            mean.append(r[4][j])
            std.append(r[5][j])
        enc = ref_encoder.MultiJoinEncoder(
            ref_encoder.load_stats(data.checked_dir(run.root, cfg["stats"])),
            chunk_norm=cfg["chunk_norm"])
        x_train, y_train = enc.encode(self.train, with_card=True)
        x_test, _ = enc.encode(lines)
        dev, f64 = run.device, torch.float64
        ref = registry.reference(cfg["tier"], run.root)
        state = ref.fit(cfg, torch.as_tensor(x_train, dtype=f64, device=dev),
                        torch.as_tensor(y_train, dtype=f64, device=dev))
        ref_mean, ref_std = ref.predict(
            cfg, state, torch.as_tensor(x_test, dtype=f64, device=dev))
        return judge.gaps(torch.as_tensor(np.asarray(mean), dtype=f64,
                                          device=dev),
                          torch.as_tensor(np.asarray(std), dtype=f64,
                                          device=dev), ref_mean, ref_std)


def control(config):
    """(config overrides, None): the configuration's control, its
    `config` keys (the program's own path in the next precision down)."""
    spec = config["control"]
    if set(spec) != {"config"}:
        raise ValueError("a served control runs the program with other "
                         "`config` keys, and nothing else")
    return dict(spec["config"]), None
