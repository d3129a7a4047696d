"""A traced sub-window: torch.profiler's device records, the busy/idle
union, and the harness's host spans placed on the same clock.

The busy/idle union is a copy of the device-activity reading of
`nngp_tpu_torch/cli/profile_slice.py` and `utils/profiling.py::
device_kernels` (kernels, copies and fills of the Chrome trace, merged
where they overlap). The session shape is that of `utils/profiling.py::
kernel_device_ms`: a warm step whose records are left out (a session's
first records can be lost), then the traced step, and a new session when a step
came back with no device record, up to TRACE_ATTEMPTS. A window's busy
time has no CUDA-event equivalent (events time the stream, idle
included), so a traced run whose sessions all come back empty fails.

The profiler records the device work of every thread but the host events
of the thread that started it only, and it cannot be started from
another thread (kineto refuses: "External init callback must run in same
thread as registerClient"). So the harness's spans, from any thread, are
kept on the host clock (`time.perf_counter`) and moved onto the trace's
clock by anchors: record_function marks made by the profiling thread at
known perf_counter readings.
"""

import json
import os
import statistics
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the marker kernel (`torch.cuda._sleep`) and how long it spins
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
TRACE_ATTEMPTS = 5
_ANCHOR = "portbench:anchor"


class Spans:
    """Host-clock spans (name, start s, end s, attrs) from any thread."""

    def __init__(self):
        self.items = []

    def add(self, name, t0, t1, **attrs):
        self.items.append((name, t0, t1, attrs))

    def named(self, name):
        return [s for s in self.items if s[0] == name]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Traced:
    """What one traced step recorded, on the host clock in seconds:
    device records (name, start, end) within [t0, t1]."""

    def __init__(self, records, t0, t1):
        self.t0, self.t1 = t0, t1
        self.records = [(n, max(s, t0), min(e, t1)) for n, s, e in records
                        if e > t0 and s < t1]
        self.busy = _merge([(s, e) for _, s, e in self.records])

    @property
    def window_s(self):
        return self.t1 - self.t0

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy)

    def gaps(self):
        """The idle intervals of the window: (start, end)."""
        out, at = [], self.t0
        for s, e in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def kernel_seconds(self, match):
        """(seconds, launches) of the device records whose names contain
        every part of `match`."""
        parts = (match,) if isinstance(match, str) else match
        hit = [e - s for n, s, e in self.records
               if all(p in n for p in parts)]
        return sum(hit), len(hit)

    def top_ops(self, k=10):
        by = {}
        for n, s, e in self.records:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda item: -item[1])[:k]

    def idle_by_span(self, spans, outside, k=10):
        """Idle seconds by the innermost host span each gap's midpoint
        falls in (`outside` where none does), largest first."""
        by = {}
        for s, e in self.gaps():
            mid = 0.5 * (s + e)
            best = None
            for name, a, b, _ in spans.items:
                if a <= mid <= b and (best is None
                                      or b - a < best[1] - best[0]):
                    best = (a, b, name)
            name = best[2] if best is not None else outside
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda item: -item[1])[:k]


def _read_trace(path):
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    records, anchors = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            records.append((e["name"], float(e["ts"]),
                            float(e["ts"]) + float(e.get("dur", 0.0))))
        elif e.get("name", "").startswith(_ANCHOR):
            anchors.append((int(e["name"][len(_ANCHOR) + 1:]),
                            float(e["ts"])))
    return records, anchors


def clock_offset(records, anchors, marks, device_marks):
    """offset with trace clock (us) = perf_counter (s) * 1e6 + offset: the
    host anchors' (index, trace us) against their perf_counter readings
    `marks`, refined on the device's own records by the marker kernels,
    each matched to the nearest of `device_marks`: the trace's device
    timestamps can sit milliseconds off its host ones."""
    offset = statistics.median(ts - marks[i] * 1e6 for i, ts in anchors)
    host = [m * 1e6 + offset for m in device_marks]
    shifts = [s - min(host, key=lambda m: abs(m - s))
              for n, s, _ in records if MARK_KERNEL in n and host]
    return offset + statistics.median(shifts) if shifts else offset


class Session:
    """One profiler session in three calls from one thread: begin() (the
    warm step starts), activate() (the traced step starts) and stop();
    then read() returns the Traced of the interval from activate() to
    stop(), records before it left out, or None when the profiler
    recorded no device activity in it."""

    def __init__(self, torch, tmp_dir):
        self.torch, self.tmp_dir = torch, tmp_dir
        self.marks = []
        self.device_marks = []

    def mark(self):
        """Launch a marker kernel and note the host clock, from the thread
        that launches the work, at a moment the device has nothing queued
        (between two batches or fits): its record places the device's
        records on the host clock within a launch's latency."""
        self.device_marks.append(time.perf_counter())
        self.torch.cuda._sleep(MARK_CYCLES)

    def _anchor(self):
        from torch.profiler import record_function

        with record_function(f"{_ANCHOR}:{len(self.marks)}"):
            self.marks.append(time.perf_counter())

    def begin(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def activate(self):
        for _ in range(3):
            self._anchor()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        for _ in range(3):
            self._anchor()
        self.prof.stop()

    def read(self):
        path = os.path.join(self.tmp_dir,
                            f"portbench_trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        try:
            records, anchors = _read_trace(path)
        finally:
            os.remove(path)
        if not (records and anchors):
            return None
        offset = clock_offset(records, anchors, self.marks,
                              self.device_marks)
        traced = Traced([(n, (s - offset) / 1e6, (e - offset) / 1e6)
                         for n, s, e in records if MARK_KERNEL not in n],
                        self.t0, self.t1)
        return traced if traced.records else None


def no_activity(attempt):
    print(f"portbench: the profiler recorded no device activity "
          f"(session {attempt + 1} of {TRACE_ATTEMPTS})", file=sys.stderr)


def traced_step(torch, warm, step, tmp_dir):
    """Run warm(session) untraced and step(session) traced in one profiler
    session, on this thread; returns the Traced of step(). New sessions,
    up to TRACE_ATTEMPTS, while a step comes back with no device
    record."""
    for attempt in range(TRACE_ATTEMPTS):
        session = Session(torch, tmp_dir)
        session.begin()
        warm(session)
        session.activate()
        step(session)
        session.stop()
        traced = session.read()
        if traced is not None:
            return traced
        no_activity(attempt)
    raise RuntimeError("the profiler recorded no device activity in "
                       f"{TRACE_ATTEMPTS} sessions")
