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
"""

import itertools
import json
import os
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
