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
"""

import itertools
import json
import os
import subprocess
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
