"""TCP line-protocol front-end for the serving Estimator.

The port's copy of `nngp_tpu/serve/socket_server.py`, with the same line
protocol. It is carried in this package because importing any
`nngp_tpu.serve` module loads jax (the package's `__init__` imports the
JAX Estimator).

Protocol (newline-delimited UTF-8, one request per line):
  request   a card-less query line in the serving grammar
            (`tables@preds_1@...@preds_k@joins`, single-table `preds`)
  response  one JSON object per line, in request order per connection:
            {"mean": m, "std": s, "card": 2**m}            always
            {"lo": .., "hi": .., "card_lo": .., "card_hi": ..}
                when `alpha` is set and the estimator has been
                `calibrate_uncertainty`'d (split-conformal bounds)
            {"error": "..."}                               per bad line
  feedback  (feedback_mode != "off") a LABELED line `query@...@card` —
            e.g. the true cardinality observed after executing the plan —
            is acknowledged immediately with {"feedback": "queued"} and
            folded into drift monitoring / online learning / automatic
            remediation in the background (see EstimatorSocketServer).
  \\stats   returns the server's metrics as one JSON line (qps, batch
            sizes, latency percentiles, feedback counters).

Concurrency: every connection gets a reader (submits lines to the shared
`StreamingBatcher`) and a writer (resolves futures in request order), so
requests from ALL connections coalesce into single predicts. A malformed
line poisons only its own future: the batcher bisects failed batches
(serve/streaming.py). At a torch.distributed world size above 1 the server
runs on rank 0 over a `serve.follower.LeadEstimator`: every predict, feedback
call and drift-monitor reset reaches the other ranks through it (a plain
Estimator raises ValueError). The model lock is always taken outside the
lead's lock.
"""

import json
import os
import queue
import socketserver
import threading
import time
from typing import Optional

from nngp_tpu_torch.serve.streaming import StreamingBatcher, require_lead


def _is_labeled(line: str) -> bool:
    """A LABELED line in the training grammar carries a trailing numeric
    cardinality field (`query@...@card`); no card-less serving field
    (predicate lists, join conditions, table lists) is ever a bare
    number."""
    tail = line.rsplit("@", 1)[-1].strip()
    if not tail:
        return False
    try:
        float(tail)
        return True
    except ValueError:
        return False


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv: "EstimatorSocketServer" = self.server.owner  # type: ignore
        pending: "queue.SimpleQueue" = queue.SimpleQueue()

        def writer():
            while True:
                fut = pending.get()
                if fut is None:
                    return
                if isinstance(fut, dict):          # pre-formed reply (ack)
                    resp = fut
                else:
                    try:
                        mean, std = fut.result(timeout=srv.timeout_s)
                        resp = srv.format_response(mean, std)
                    except Exception as e:  # noqa: BLE001 - to the client
                        resp = {"error": f"{type(e).__name__}: {e}"}
                try:
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return

        wt = threading.Thread(target=writer, daemon=True,
                              name="nngp-sock-writer")
        wt.start()
        try:
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                try:
                    if line == "\\stats":
                        pending.put(srv.stats())
                    elif srv.feedback_mode != "off" and _is_labeled(line):
                        pending.put(srv._submit_feedback(line))
                    else:
                        pending.put(srv.batcher.submit(line))
                except RuntimeError:  # server closing
                    break
        except (ConnectionResetError, OSError):
            pass
        finally:
            pending.put(None)
            wt.join(timeout=srv.timeout_s)


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class EstimatorSocketServer:
    """Serve `estimator.predict` over TCP with cross-connection batching.

    estimator: anything with `.predict(lines) -> (means, stds)` — the
    serving `Estimator`; split-conformal intervals are attached when
    `alpha` is given and the estimator carries `_conformal_scores`
    (set by `Estimator.calibrate_uncertainty`).

    feedback_mode closes the online-learning loop over the wire: a client
    (e.g. the DBMS after executing a plan) sends a LABELED line — the
    training grammar's `query@...@card`, told apart by its trailing
    numeric field — and gets `{"feedback": "queued"}` back at once. A
    background worker batches labeled lines (feedback_batch lines or
    feedback_flush_s seconds, whichever first) and:

      'monitor'  folds them into the drift detector only
                 (`Estimator.record_feedback`);
      'online'   monitor + `extend_with_lines` (the posterior learns the
                 labels incrementally);
      'auto'     online + on a drift alarm the report's remediation,
                 then a reset of the monitor: `relearn_hyperparams` on the
                 exact tier; on the Nystrom tier `grow_inducing`, which
                 needs the full training log back (`train_log`: the
                 labeled lines the server was trained with, or the path
                 of its query directory; the feedback received so far is
                 appended). Without a log the growth is skipped, counted
                 in stats()['remediations_skipped'], and the monitor
                 resets so the alarm cannot latch. When the estimator was
                 calibrated, the conformal scores are refreshed on the
                 next feedback batch before it is folded into training
                 (those lines are still held out, which the
                 split-conformal guarantee requires).

    Malformed labeled lines are validated per line and cost only
    themselves (stats()['feedback_errors']), never the batch.

    Model mutations and predict batches serialize on one lock, and an
    extend installs a new posterior object or, on a padded posterior,
    writes its slots under the Estimator's own lock, so a client never
    reads a half-installed posterior. The batcher's dispatcher and the feedback
    worker both launch on the device's default stream.

    port=0 binds an ephemeral port (read `.port`). Context manager.
    """

    def __init__(self, estimator, host: str = "127.0.0.1", port: int = 0,
                 alpha: Optional[float] = None, timeout_s: float = 120.0,
                 feedback_mode: str = "off", feedback_batch: int = 64,
                 feedback_flush_s: float = 2.0, train_log=None,
                 **batcher_kwargs):
        require_lead(estimator, "EstimatorSocketServer")
        if feedback_mode not in ("off", "monitor", "online", "auto"):
            raise ValueError(
                "feedback_mode must be off|monitor|online|auto, got "
                f"{feedback_mode!r}")
        self.estimator = estimator
        self.alpha = alpha
        self.timeout_s = float(timeout_s)
        self.feedback_mode = feedback_mode
        self.feedback_batch = int(feedback_batch)
        self.feedback_flush_s = float(feedback_flush_s)
        # the labeled lines the server was trained with (the Nystrom
        # growth refits on them): a list, or a query directory whose
        # non-aux *.txt files are read at the first growth
        self.train_log = (train_log if isinstance(train_log, str)
                          else list(train_log) if train_log is not None
                          else None)
        self._fb_log: list = []          # every valid labeled line received
        self._model_lock = threading.Lock()
        self._fb_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._fb_stats = {"feedback_lines": 0, "feedback_batches": 0,
                          "extends": 0, "drift_alarms": 0,
                          "remediations": 0, "remediations_skipped": 0,
                          "feedback_errors": 0}
        self._recal_pending = False
        self._fb_running = feedback_mode != "off"

        self.batcher = StreamingBatcher(self._locked_predict,
                                        **batcher_kwargs)
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.owner = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="nngp-sock-accept")
        self._thread.start()
        self._fb_thread = None
        if self._fb_running:
            self._fb_thread = threading.Thread(
                target=self._feedback_loop, daemon=True,
                name="nngp-sock-feedback")
            self._fb_thread.start()

    def _locked_predict(self, lines):
        """The batcher's predict: under the model lock, which the feedback
        worker takes around every model update."""
        with self._model_lock:
            return self.estimator.predict(list(lines))

    # ------------------------------------------------------ feedback loop
    def _submit_feedback(self, line: str) -> dict:
        self._fb_queue.put(line)
        return {"feedback": "queued", "mode": self.feedback_mode}

    def _resolve_train_log(self):
        if isinstance(self.train_log, str):
            lines = []
            for fn in sorted(os.listdir(self.train_log)):
                if not fn.endswith(".txt") or "aux" in fn:
                    continue
                with open(os.path.join(self.train_log, fn)) as f:
                    lines.extend(ln.strip() for ln in f if ln.strip())
            self.train_log = lines
        return self.train_log

    def _feedback_loop(self):
        batch = []
        batch_t0 = 0.0
        while self._fb_running:
            try:
                item = self._fb_queue.get(timeout=0.1)
                if not batch:
                    # the flush clock starts at the batch's first line, so
                    # a trickle still coalesces
                    batch_t0 = time.monotonic()
                batch.append(item)
            except queue.Empty:
                pass
            if batch and (len(batch) >= self.feedback_batch
                          or time.monotonic() - batch_t0
                          >= self.feedback_flush_s):
                lines, batch = batch, []
                self._apply_feedback(lines)
        # final drain on close
        try:
            while True:
                batch.append(self._fb_queue.get_nowait())
        except queue.Empty:
            pass
        if batch:
            self._apply_feedback(batch)

    def _apply_feedback(self, lines):
        est = self.estimator
        st = self._fb_stats
        # Per-line parse/encode validation FIRST: one malformed line (the
        # client already got its optimistic ack) must cost only itself,
        # never the valid labels sharing its flush window.
        good = []
        for ln in lines:
            try:
                est._encode_labeled_lines([ln], "socket_feedback")
                good.append(ln)
            except Exception:  # noqa: BLE001 — reported via \stats
                st["feedback_errors"] += 1
        if not good:
            return
        try:
            with self._model_lock:
                report = est.record_feedback(good)
                st["feedback_lines"] += len(good)
                st["feedback_batches"] += 1
                self._fb_log.extend(good)
                # a remediation moved the posterior: refresh the stale
                # conformal calibration on this batch BEFORE extending with
                # it, while its lines are still held out
                if (self._recal_pending
                        and getattr(est, "_conformal_scores", None)
                        is not None):
                    est.calibrate_uncertainty(good, verbose=False)
                    self._recal_pending = False
                if self.feedback_mode in ("online", "auto"):
                    est.extend_with_lines(good)
                    st["extends"] += 1
                if report.drift:
                    st["drift_alarms"] += 1
                if report.drift and self.feedback_mode == "auto":
                    if (report.action == "grow_inducing"
                            and self.train_log is None):
                        # growth needs the full training log back
                        st["remediations_skipped"] += 1
                    else:
                        if report.action == "grow_inducing":
                            est.grow_inducing(self._resolve_train_log()
                                              + self._fb_log)
                        else:
                            est.relearn_hyperparams(verbose=False)
                        st["remediations"] += 1
                        self._recal_pending = True
                    est.drift_monitor.reset()
        except Exception:  # noqa: BLE001 — the worker must survive
            st["feedback_errors"] += len(good)

    def format_response(self, mean, std) -> dict:
        m, s = float(mean), float(std)
        resp = {"mean": m, "std": s, "card": float(2.0 ** m)}
        scores = getattr(self.estimator, "_conformal_scores", None)
        if self.alpha is not None and scores is not None:
            from nngp_tpu_torch.eval.calibration import conformal_quantile
            qhat = conformal_quantile(scores, self.alpha)
            lo, hi = m - qhat * s, m + qhat * s
            resp.update(lo=lo, hi=hi, card_lo=float(2.0 ** lo),
                        card_hi=float(2.0 ** hi))
        return resp

    def stats(self) -> dict:
        out = self.batcher.stats()
        if self.feedback_mode != "off":
            out.update(self._fb_stats)
        return out

    def close(self, timeout: float = 10.0):
        self._tcp.shutdown()
        self._tcp.server_close()
        self.batcher.close(timeout=timeout)
        if self._fb_thread is not None:
            self._fb_running = False
            self._fb_thread.join(timeout=timeout)
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
