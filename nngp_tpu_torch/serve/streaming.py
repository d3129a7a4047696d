"""Streaming / continuous-batching front-end for the serving estimator.

A copy of `nngp_tpu/serve/streaming.py` (numpy and the standard library
only), carried in this package because importing any `nngp_tpu.serve`
module loads jax (the package's `__init__` imports the JAX Estimator).
Two faults of the original are fixed here; `tests/test_torch_serve_
frontends.py` shows each against both modules:
  - on a dispatch failure in pipelined mode, the batch already in flight
    is fetched and finished BEFORE the failed batch is re-run
    synchronously (the original re-ran first, holding back the clients of
    an older batch behind a newer one's retries);
  - the single-item retry after a failed fetch takes its ship time BEFORE
    the retry's predict, so the retry counts as service time, not as
    queue wait.

The reference's serving API is synchronous batch-at-a-time (the
PostgreSQL plugin hands over one list of sub-query lines per call). For
concurrent clients this module enqueues requests from any thread, lets a
dispatcher coalesce them into batches, runs ONE predict per batch, and
resolves per-request futures. Every predict has a fixed cost (host
encode, kernel launches, one device-to-host copy), so one batch of k
requests costs far less than k single predicts.

Batching policy:
  - while requests keep arriving within `quiet_gap_ms` of each other, keep
    draining, so an active burst is absorbed into ONE predict instead of a
    small head batch plus a tail batch that waits two service cycles;
  - once the queue stays quiet for a gap, ship at once: a trickle pays
    only the gap, not the whole SLO window;
  - `max_wait_ms` (from the batch's first item) bounds the wait under
    sustained arrival, and `max_batch` caps the rows of one predict;
  - BACKLOG SHIPPING (default on): when the dispatcher wakes from serving
    a batch to a non-empty queue, that backlog accumulated during the
    service and is already a grouped batch, so it ships with no capture
    wait. An idle wake keeps the quiet-gap capture.

Host-side costs matter as much as the policy: per-item timed gets,
per-request `concurrent.futures.Future` allocations (whose garbage
collection pauses the producer past the quiet gap) and per-future lock
round trips at resolution each fragment burst capture. Hence SlimFuture
(one shared condition variable), full-gap sleeps between bulk drains, a
two-quiet-gap hysteresis while a burst is active, and batch resolution
under one condition-variable acquisition.

Generic over the request payload: `predict_fn(items) -> (mean, std)` — pass
`Estimator.predict` for query-line items, or any row-wise batch function.

At a `torch.distributed` world size above 1 (an SPMD distributed
Estimator) the batcher runs on rank 0 with a `serve.follower.LeadEstimator`'s
predict as predict_fn, which the other ranks replay in `follow`; any other
predict_fn, and the pipelined mode, raise ValueError, since one rank's
collective alone would wait forever.

PIPELINED MODE (opt-in): pass `dispatch_fn(items) -> handle` +
`fetch_fn(handle) -> (mean, std)` instead of `predict_fn` to dispatch
batch k+1 before blocking on batch k's fetch, overlapping device work
with the fetch on one thread. It pays off only where a fetch blocks for
long while the device is busy; the default synchronous mode is the
serving path.
"""

import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, TimeoutError as FutTimeout
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_PENDING, _RESULT, _EXC, _CANCELLED = 0, 1, 2, 3


def require_lead(estimator, what: str):
    """At a torch.distributed world size above 1, raise ValueError unless
    `estimator` is a `serve.follower.LeadEstimator`, or a front end whose
    `estimator` is one. Read without importing torch: no group exists
    unless torch.distributed was imported."""
    dist = sys.modules.get("torch.distributed")
    if not (dist is not None and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1):
        return
    from nngp_tpu_torch.serve.follower import LeadEstimator
    if not isinstance(getattr(estimator, "estimator", estimator),
                      LeadEstimator):
        raise ValueError(
            f"{what} at world size {dist.get_world_size()} serves a "
            "distributed Estimator from rank 0 through "
            "nngp_tpu_torch.serve.follower.LeadEstimator, the other ranks "
            f"in serve.follower.follow; got {estimator!r}")


class SlimFuture:
    """Minimal per-request future sharing ONE condition variable across the
    whole batcher. `concurrent.futures.Future` allocates a lock, a
    condition and a waiter list per instance; at thousands of requests per
    burst that allocation pressure fires cyclic-GC collections whose pauses
    exceed the quiet gap — fragmenting burst capture into multiple
    batches and slowing the submit loop. One shared condvar and
    `__slots__` cut per-request allocations to this object and its queue
    tuple. Supports the consumer surface the framework uses:
    result(timeout) / done() / cancelled() / cancel().
    """

    __slots__ = ("_cond", "_state", "_value")

    def __init__(self, cond: threading.Condition):
        self._cond = cond
        self._state = _PENDING
        self._value = None

    def done(self) -> bool:
        return self._state != _PENDING

    def cancelled(self) -> bool:
        return self._state == _CANCELLED

    def cancel(self) -> bool:
        with self._cond:
            if self._state == _PENDING:
                self._state = _CANCELLED
                self._cond.notify_all()
                return True
            return self._state == _CANCELLED

    def result(self, timeout: Optional[float] = None):
        with self._cond:
            if self._state == _PENDING:
                self._cond.wait_for(lambda: self._state != _PENDING,
                                    timeout)
            state = self._state
            if state == _RESULT:
                return self._value
            if state == _EXC:
                raise self._value
            if state == _CANCELLED:
                raise CancelledError()
            raise FutTimeout(
                f"request not resolved within {timeout} s")

    def exception(self, timeout: Optional[float] = None):
        # branch on STATE, not on exception type: a stored exception that
        # happens to be a CancelledError (predict_fn raised it) must be
        # RETURNED like any other failure, not mistaken for a client-side
        # cancel — only the _CANCELLED state means cancelled.
        with self._cond:
            if self._state == _PENDING:
                self._cond.wait_for(lambda: self._state != _PENDING,
                                    timeout)
            state = self._state
            if state == _EXC:
                return self._value
            if state == _RESULT:
                return None
            if state == _CANCELLED:
                raise CancelledError()
            raise FutTimeout(
                f"request not resolved within {timeout} s")

    # dispatcher-side single set (error / bisect paths); the batch fast
    # path in StreamingBatcher._resolve writes _state/_value directly
    # under the shared condvar and notifies once for the whole batch.
    def _set(self, state: int, value) -> None:
        with self._cond:
            if self._state == _PENDING:
                self._state = state
                self._value = value
                self._cond.notify_all()


class StreamingBatcher:
    """Continuous batching: submit() returns a Future resolving to
    (mean, std) for that single item; a background dispatcher coalesces
    outstanding items into one predict_fn call per batch.

    max_batch caps device memory per dispatch; quiet_gap_ms is how long the
    queue must stay quiet before a partial batch ships (burst-vs-trickle
    detector); max_wait_ms (from the batch's first item) bounds the total
    wait under sustained arrival.
    """

    def __init__(self, predict_fn: Optional[Callable[[List], Tuple]] = None,
                 *, max_batch: int = 4096, max_wait_ms: float = 25.0,
                 quiet_gap_ms: float = 2.0,
                 dispatch_fn: Optional[Callable[[List], object]] = None,
                 fetch_fn: Optional[Callable[[object], Tuple]] = None,
                 backlog_ship: bool = True,
                 name: str = "nngp-stream"):
        # at world size > 1 only a lead's predict (or the socket server's
        # locked one over a lead): the pipelined mode has no predict_fn
        require_lead(getattr(predict_fn, "__self__", None),
                     "StreamingBatcher")
        if (dispatch_fn is None) != (fetch_fn is None):
            raise ValueError(
                "pipelined mode needs BOTH dispatch_fn and fetch_fn")
        self._dispatch_fn = dispatch_fn
        self._fetch_fn = fetch_fn
        # backlog shipping: skip the capture wait when the dispatcher wakes
        # to a non-empty queue right after serving a batch (_drain_batch
        # docstring). Default on; False restores the unconditional
        # quiet-gap policy.
        self._backlog_ship = bool(backlog_ship)
        if predict_fn is None:
            if dispatch_fn is None:
                raise ValueError(
                    "pass predict_fn, or dispatch_fn + fetch_fn")
            # composed synchronous path: used for bisection after a batch
            # failure, where re-running sub-batches serially is fine
            predict_fn = lambda items: fetch_fn(dispatch_fn(items))  # noqa: E731
        self._predict_fn = predict_fn
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._quiet_gap_s = float(quiet_gap_ms) / 1e3
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._running = True
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._cond = threading.Condition()   # shared by all SlimFutures
        # metrics
        self._n_requests = 0
        self._n_batches = 0
        self._batch_sizes: deque = deque(maxlen=4096)
        self._latencies: deque = deque(maxlen=65536)
        # per-item latency decomposition (same maxlen as _latencies so the
        # quantiles describe the same window): queue wait = enqueue ->
        # predict_fn start; service = predict_fn start -> futures resolved
        # (host encode + kernel launches + device work + the result copy)
        self._queue_waits: deque = deque(maxlen=65536)
        self._services: deque = deque(maxlen=65536)
        self._started = time.monotonic()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, item) -> SlimFuture:
        """Enqueue one request; resolves to (mean, std) scalars."""
        fut = SlimFuture(self._cond)
        # _submit_lock pairs with close(): no request can slip past the
        # _running check after close() decided the final drain. It is
        # uncontended on the hot path (producers only race close()).
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("StreamingBatcher is closed")
            self._queue.put((item, fut, time.monotonic()))
        return fut

    def predict(self, items: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience: submit all, wait for all."""
        futs = [self.submit(it) for it in items]
        out = [f.result() for f in futs]
        means = np.asarray([m for m, _ in out])
        stds = np.asarray([s for _, s in out])
        return means, stds

    # --------------------------------------------------------- dispatcher
    def _drain_batch(self, first_timeout: float = 0.05,
                     immediate: bool = False) -> Optional[List]:
        """Block for the first item, then keep draining while requests keep
        arriving within the quiet gap; ship when the queue stays quiet, the
        SLO window closes, or the batch fills.

        The capture loop sleeps a FULL quiet gap between bulk drains rather
        than doing a timed get() per item: a timed get wakes the dispatcher
        on every put, and on a host with few cores each wakeup preempts the
        producer mid-burst and fragments the capture. One sleep per gap
        lets the producer run uninterrupted and the drain
        collect its items in one sweep; a trickle still pays only the gap.

        immediate=True (backlog shipping): sweep what is already queued and
        ship with NO capture wait. Callers pass it only when the dispatcher
        just finished a batch AND the queue is non-empty at wake — that
        backlog accumulated during the previous service, which
        already did the capture window's grouping job; waiting another SLO
        window on top is pure added latency under sustained arrival. An
        idle wake (empty queue) always takes the capture path, so burst
        absorption is unchanged.
        """
        try:
            first = self._queue.get(timeout=first_timeout)
        except queue.Empty:
            return None
        batch = [first]
        if immediate:
            try:
                while len(batch) < self._max_batch:
                    batch.append(self._queue.get_nowait())
            except queue.Empty:
                pass
            return batch
        deadline = time.monotonic() + self._max_wait_s
        while len(batch) < self._max_batch:
            before = len(batch)
            try:
                while len(batch) < self._max_batch:
                    batch.append(self._queue.get_nowait())
            except queue.Empty:
                pass
            if len(batch) >= self._max_batch:
                break
            # Hysteresis: while a burst is clearly active (the last sweep
            # drained many items), one empty sample is not "quiet" — the
            # producer may merely be paused by a GC collection or a
            # scheduler preemption longer than the gap. Demand TWO consecutive quiet gaps before
            # shipping mid-burst; a trickle still ships after one.
            need_quiet = 2 if (len(batch) - before) > 64 else 1
            quiet = 0
            while quiet < need_quiet:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    quiet = need_quiet      # SLO window closed: ship
                    break
                time.sleep(min(self._quiet_gap_s, remaining))
                if self._queue.empty():
                    quiet += 1
                else:
                    break                   # new arrivals: drain again
            if quiet >= need_quiet:
                break                       # queue stayed quiet: ship now
        return batch

    def _dispatch_loop(self):
        if self._dispatch_fn is not None:
            return self._dispatch_loop_pipelined()
        was_busy = False
        while self._running or not self._queue.empty():
            immediate = (self._backlog_ship and was_busy
                         and not self._queue.empty())
            batch = self._drain_batch(immediate=immediate)
            was_busy = bool(batch)
            if not batch:
                continue
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            t_enq = [b[2] for b in batch]
            self._resolve(items, futs, t_enq)

    def _dispatch_loop_pipelined(self):
        """Software pipeline on ONE thread: dispatch the next batch before
        blocking on the previous batch's fetch, overlapping device work
        with the fetch (module docstring, PIPELINED MODE).
        `in_flight` holds at most one dispatched-but-unfetched batch."""
        in_flight = None        # (handle, items, futs, t_enq, t_ship)
        was_busy = False
        while self._running or not self._queue.empty() or in_flight:
            # with a batch in flight, only poll briefly for new arrivals —
            # the pending batch's clients are waiting on its fetch. A
            # backlog at wake ships immediately (no capture wait): the
            # in-flight batch's fetch must not queue behind an SLO window.
            immediate = (self._backlog_ship
                         and (in_flight is not None or was_busy)
                         and not self._queue.empty())
            batch = self._drain_batch(
                first_timeout=0.002 if in_flight else 0.05,
                immediate=immediate)
            was_busy = bool(batch) or in_flight is not None
            nxt = None
            if batch:
                items = [b[0] for b in batch]
                futs = [b[1] for b in batch]
                t_enq = [b[2] for b in batch]
                t_ship = time.monotonic()
                try:
                    handle = self._dispatch_fn(items)
                    nxt = (handle, items, futs, t_enq, t_ship)
                except Exception:
                    # dispatch itself failed. Finish the batch already in
                    # flight first: its clients have waited longer, and
                    # its work was dispatched first. Then isolate the
                    # failure via the synchronous bisection path.
                    if in_flight is not None:
                        self._fetch_and_finish(*in_flight)
                        in_flight = None
                    self._resolve(items, futs, t_enq)
            if in_flight is not None:
                self._fetch_and_finish(*in_flight)
            in_flight = nxt

    def _fetch_and_finish(self, handle, items, futs, t_enq, t_ship):
        try:
            mean, std = self._fetch_fn(handle)
            self._finish_batch(items, futs, t_enq, t_ship, mean, std)
        except Exception:
            # fetch/validation failed: re-run the batch through the
            # synchronous composed path with bisection
            if len(items) == 1:
                # the retry ships now: its predict is service time
                t_retry = time.monotonic()
                try:
                    mean, std = self._predict_fn(items)
                    self._finish_batch(items, futs, t_enq, t_retry, mean,
                                       std)
                except Exception as e:
                    self._safe_set(futs[0], exc=e)
                return
            mid = len(items) // 2
            self._resolve(items[:mid], futs[:mid], t_enq[:mid])
            self._resolve(items[mid:], futs[mid:], t_enq[mid:])

    # A client may cancel its future at any moment; SlimFuture._set is a
    # no-op on anything already cancelled/resolved, so the dispatcher
    # thread can never die on a set race (the concurrent.futures
    # InvalidStateError failure mode).
    @staticmethod
    def _safe_set(fut: SlimFuture, result=None, exc=None):
        if exc is not None:
            fut._set(_EXC, exc)
        else:
            fut._set(_RESULT, result)

    def _finish_batch(self, items, futs, t_enq, t_ship, mean, std):
        """Validate a batch's predictions, record metrics, resolve futures.
        Raises on malformed predictions (callers bisect)."""
        mean = np.asarray(mean).ravel()
        std = np.asarray(std).ravel()
        if mean.shape[0] != len(items):
            # e.g. Estimator.predict silently drops blank lines —
            # resolving positionally would hand each later client
            # its neighbor's prediction. Fail the batch loudly.
            raise ValueError(
                f"predict_fn returned {mean.shape[0]} results for "
                f"{len(items)} requests (did it drop empty items?)")
        done = time.monotonic()
        with self._lock:
            self._n_requests += len(items)
            self._n_batches += 1
            self._batch_sizes.append(len(items))
            self._latencies.extend(done - t for t in t_enq)
            self._queue_waits.extend(t_ship - t for t in t_enq)
            # one service value PER ITEM so the quantiles weight each
            # request, not each batch (a 4k burst batch and a 1-item
            # trickle batch serve very different request counts)
            self._services.extend(
                (done - t_ship) for _ in range(len(items)))
        mvals, svals = mean.tolist(), std.tolist()
        # Batch fast path: one condvar acquisition + ONE notify_all for
        # the whole batch instead of a lock round-trip per future.
        with self._cond:
            for f, m, s in zip(futs, mvals, svals):
                if f._state == _PENDING:
                    f._state = _RESULT
                    f._value = (float(m), float(s))
            self._cond.notify_all()

    def _resolve(self, items, futs, t_enq):
        """Predict a batch and resolve its futures. On failure, BISECT:
        the bad requests are isolated in O(k log n) sub-dispatches instead
        of n serial per-item retries (one malformed line in a 4k batch
        would otherwise stall coalescing for ~n serial predicts)."""
        try:
            t_ship = time.monotonic()
            mean, std = self._predict_fn(items)
            self._finish_batch(items, futs, t_enq, t_ship, mean, std)
        except Exception as e:
            if len(items) == 1:
                self._safe_set(futs[0], exc=e)
                return
            mid = len(items) // 2
            self._resolve(items[:mid], futs[:mid], t_enq[:mid])
            self._resolve(items[mid:], futs[mid:], t_enq[mid:])

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            qw = np.asarray(self._queue_waits, dtype=np.float64)
            sv = np.asarray(self._services, dtype=np.float64)
            sizes = np.asarray(self._batch_sizes, dtype=np.float64)
            elapsed = time.monotonic() - self._started
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "qps": self._n_requests / elapsed if elapsed > 0 else 0.0,
                "mean_batch": float(sizes.mean()) if sizes.size else 0.0,
                "max_batch": float(sizes.max()) if sizes.size else 0.0,
                "p50_latency_ms": (float(np.quantile(lat, 0.5)) * 1e3
                                   if lat.size else 0.0),
                "p95_latency_ms": (float(np.quantile(lat, 0.95)) * 1e3
                                   if lat.size else 0.0),
                "p99_latency_ms": (float(np.quantile(lat, 0.99)) * 1e3
                                   if lat.size else 0.0),
                # latency decomposition (per-item): total = queue wait
                # (enqueue -> ship; the batching policy's cost) + service
                # (ship -> resolved; host encode + launches + device work +
                # the result copy).
                "p50_queue_wait_ms": (float(np.quantile(qw, 0.5)) * 1e3
                                      if qw.size else 0.0),
                "p95_queue_wait_ms": (float(np.quantile(qw, 0.95)) * 1e3
                                      if qw.size else 0.0),
                "p50_service_ms": (float(np.quantile(sv, 0.5)) * 1e3
                                   if sv.size else 0.0),
                "p95_service_ms": (float(np.quantile(sv, 0.95)) * 1e3
                                   if sv.size else 0.0),
            }

    def close(self, timeout: float = 10.0):
        """Stop accepting requests, drain the queue, join the dispatcher.
        Anything still unresolved afterwards (dispatcher hung past the
        timeout) gets its future failed rather than left hanging."""
        with self._submit_lock:
            self._running = False
        self._thread.join(timeout=timeout)
        # Fail any leftovers so no client blocks forever on fut.result().
        try:
            while True:
                _, fut, _ = self._queue.get_nowait()
                self._safe_set(fut, exc=RuntimeError(
                    "StreamingBatcher closed before this request was "
                    "dispatched"))
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
