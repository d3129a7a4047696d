"""Structured profiling: the counterpart of `nngp_tpu/utils/profiling.py`.

`trace(dir)` wraps a block in a `torch.profiler` trace of the host and,
where a GPU is present, its CUDA timeline, and writes it into `dir` as a
Chrome trace JSON (`trace_<pid>_<n>.json`, viewable in Perfetto or
chrome://tracing): the JAX package writes a TensorBoard profile there.
`annotate(name)` names a region of the timeline. A named region also shows
on the device timeline (as `gpu_user_annotation`) and spans the gaps in
it, so it is not device time: `device_kernels` reads a trace's device
kernels without them, as `cli/profile_slice.py` counts device activity.
`Metrics` accumulates named scalars and dumps one JSON object.
`kernel_device_ms` is the reading of a kernel's own device time that
`chip_smoke.py` and `cli/gemm_bench.py` share; `gpu_clocks` reads the card's SM clock, its maximum
and the active throttle reasons to print beside a timed row.

`span(name, **attrs)` records a span of the program's own host work, from
any thread, in one process-wide recorder that is off until `enable()`:
off, it returns one shared no-op object and keeps nothing. A `Span` holds
its name, its start and end on `time.perf_counter` (the clock on which a
benchmark places host spans beside a device trace), its id, the id of the
span open around it on the same thread (0 at the top; each thread keeps
its own stack, so a batcher's dispatcher thread nests as its callers'
threads do), the thread's ident and its attrs: the counts of the boundary
it sits on (rows, lines, hits, bucket, reason), set at the start or by
`Span.set` / `Span.add` before it ends. `current()` is the innermost open
span of the calling thread. `take()` returns, then clears, the spans kept
(at most `SPAN_CAPACITY`) and the count of those dropped past it;
`disable()` before `take()` leaves no span still open to land after it.
Unlike `annotate`, a span is kept whichever thread records it and whether
or not a profiler runs. The serving path (`serve/streaming.py`,
`serve/estimator.py`, `serve/graphs.py`) and the Nystrom fit
(`gp/nystrom.py`) record one span per batch, chunk, panel or stage, never
one per line or row.
"""

import itertools
import json
import os
import subprocess
import threading
import time
from contextlib import contextmanager

import torch

_TRACES = itertools.count()
_SETTLE_S = 0.1


@contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block (host + device timelines),
    exported as a Chrome trace JSON into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    if torch.cuda.is_available():
        # the tracer drops device activity stamped before its window opens,
        # and the device's stamps can trail the host clock it opens by (a
        # long-running process lost the first kernels of a traced fit):
        # let the window open before the block's first launch
        torch.cuda.synchronize()
        time.sleep(_SETTLE_S)
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


@contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


def device_kernels(trace_path: str) -> dict:
    """Kernel name -> (launches, device ms) of a Chrome trace that `trace`
    wrote: its `kernel` events, without annotated ranges."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + float(e.get("dur", 0.0)) / 1e3)
    return out


TRACE_ATTEMPTS = 5
# nvidia-smi's fields for `gpu_clocks`; the throttle reasons' field took a
# new name in newer drivers, so each name is tried in turn
_CLOCK_FIELDS = ("clocks.sm", "clocks.max.sm")
_REASON_FIELDS = ("clocks_event_reasons.active",
                  "clocks_throttle_reasons.active")


def _matches(key: str, match) -> bool:
    return all(part in key for part in
               ((match,) if isinstance(match, str) else match))


def kernel_device_ms(fn, match, reps: int = 10,
                     attempts: int = TRACE_ATTEMPTS):
    """(ms a call, source) of the device time of the kernels whose names
    contain `match` (a string, or a tuple of strings that must all appear)
    over `reps` calls of fn: the sum of torch.profiler's CUDA records of
    them (the wrappers' other launches left out), source 'profiler'. Each
    profiler session runs one untraced step of `reps` calls first (a
    session's first records can be lost). The profiler has returned no
    record of a kernel in sessions in a row, deep in a long run on an H100:
    after `attempts` such sessions the CUDA-event ms of the `reps` calls,
    wrappers included, stands in, source 'cuda events'."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if _matches(e.key, match))
        if total:
            return total / 1e3 / reps, "profiler"
        print(f"  the profiler recorded no {match} (session {attempt + 1} "
              f"of {attempts})")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "cuda events"


def gpu_clocks(index: int = 0) -> dict:
    """The card's SM clock and its maximum (MHz) and the active clock
    throttle reasons (nvidia-smi's bit mask; 0x0 is none), as nvidia-smi
    reports them now; {'error': ...} when it cannot."""
    err = ""
    for reasons in _REASON_FIELDS:
        fields = (*_CLOCK_FIELDS, reasons)
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={index}",
                 f"--query-gpu={','.join(fields)}",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            return {"error": repr(e)}
        if out.returncode == 0 and out.stdout.strip():
            values = [v.strip() for v in
                      out.stdout.strip().splitlines()[0].split(",")]
            return {"sm_mhz": values[0], "max_sm_mhz": values[1],
                    "throttle_reasons": values[2]}
        err = (out.stderr or out.stdout).strip()
    return {"error": err}


class Metrics:
    def __init__(self):
        self._values = {}

    def record(self, name: str, value):
        self._values[name] = value

    @contextmanager
    def timeit(self, name: str, block_on=None):
        from nngp_tpu_torch.utils.timing import sync
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            sync(holder.get("out", block_on))
            self._values[f"{name}_s"] = time.perf_counter() - t0

    def dump(self, path=None):
        payload = json.dumps(self._values, default=float)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload


# ------------------------------------------------------------------ spans
# at most this many spans kept between two take() calls; a 40 s serving or
# refit window records about 10,000
SPAN_CAPACITY = 200_000


class Span:
    """One span of host work (module docstring). Used as a context
    manager, from `span()`."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "thread", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = None

    def set(self, **attrs):
        """Set attrs known only once the work has run."""
        self.attrs.update(attrs)

    def add(self, key: str, n: int = 1):
        """Add n to the count `key`, from code that runs inside the span."""
        self.attrs[key] = self.attrs.get(key, 0) + n

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_IDS)
        self.thread = threading.get_ident()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        _stack().pop()
        _RECORDER.keep(self)
        return False


class _NoSpan:
    """What `span()` and `current()` return while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def add(self, key, n=1):
        pass


NO_SPAN = _NoSpan()
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Recorder:
    def __init__(self):
        self.on = False
        self.capacity = SPAN_CAPACITY
        self.spans = []
        self.dropped = 0
        self.lock = threading.Lock()

    def keep(self, s: Span):
        if not self.on:
            return
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(s)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


def span(name: str, **attrs):
    """A span named `name` around a block (module docstring); the shared
    no-op while the recorder is off."""
    if not _RECORDER.on:
        return NO_SPAN
    return Span(name, attrs)


def current():
    """The innermost open span of the calling thread (the no-op when
    there is none or the recorder is off)."""
    if not _RECORDER.on:
        return NO_SPAN
    stack = _stack()
    return stack[-1] if stack else NO_SPAN


def enable():
    """Start keeping spans."""
    _RECORDER.on = True


def disable():
    """Stop keeping spans; what was kept stays until `take()`."""
    _RECORDER.on = False


def take():
    """(spans, dropped): the spans kept since the last take, in the order
    they ended, and the count dropped past SPAN_CAPACITY; both cleared."""
    rec = _RECORDER
    with rec.lock:
        spans, rec.spans = rec.spans, []
        dropped, rec.dropped = rec.dropped, 0
    return spans, dropped
