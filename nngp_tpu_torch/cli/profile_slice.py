"""Where the time of the slice's warm fit and warm predict goes.

    python -m nngp_tpu_torch.cli.profile_slice --device cuda \
        --query_path workloads/forest_data [--kernel_type ntk] [--x64]

Takes the training CLI's flags (same workload, split, kernel and fit) plus
--reps. After one cold fit and one cold predict, for each phase:

  wall_ms     host clock around the synchronized call, median of --reps;
  busy_ms     the union of the device activity intervals (kernels, copies,
              fills) of one more call, traced by torch.profiler;
  idle        1 - busy_ms / the host-clock wall of that traced call (the
              tracer's host overhead counts as idle, so this is an upper
              bound);
  top         device ms per kernel name in the traced call, largest first;
  peak_gib    torch.cuda.max_memory_allocated over the traced call.

The device fields are null on the CPU, and when the tracer records no
device activity. Prints one JSON line per phase.
"""

import collections
import json
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from nngp_tpu_torch.cli import train
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.utils.device import resolve_device, working_dtype

TOP_KERNELS = 8


def union_length(intervals) -> float:
    """Total length covered by the union of (start, end) intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def profile_phase(fn, device, reps: int) -> dict:
    out = {"wall_ms": statistics.median(_wall_ms(fn, device)
                                        for _ in range(reps)),
           "busy_ms": None, "idle": None, "top": None, "peak_gib": None}
    if device.type != "cuda":
        return out
    torch.cuda.reset_peak_memory_stats(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        traced_ms = _wall_ms(fn, device)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        return out
    busy_ms = union_length((s, e) for _, s, e in spans) / 1e3
    per_name = collections.Counter()
    for name, start, end in spans:
        per_name[name] += (end - start) / 1e3
    out.update(busy_ms=busy_ms, idle=1.0 - busy_ms / traced_ms,
               top=[[name[:80], ms]
                    for name, ms in per_name.most_common(TOP_KERNELS)])
    return out


def main(argv=None):
    p = train.build_parser()
    p.add_argument("--reps", type=int, default=5,
                   help="timed calls per phase (the median is reported)")
    args = p.parse_args(argv)
    train.reject_unported(p, args)
    if args.reps < 1:
        p.error("--reps must be >= 1")
    device = resolve_device(args.device)
    x_tr, y_tr, _, x_te, _, _ = train.load_split(args)
    spec = train.spec_from_args(args)
    x_te = torch.as_tensor(x_te, dtype=working_dtype(args.x64),
                           device=device)

    def fit():
        return fit_gp(spec, x_tr, y_tr, diag_reg=args.diag_reg,
                      get=args.kernel_type, device=device)

    post = fit()
    post.predict_mean_std(x_te)
    records = []
    for phase, fn in (("fit", fit),
                      ("predict", lambda: post.predict_mean_std(x_te))):
        rec = {"phase": phase, "kernel_type": args.kernel_type,
               "dtype": str(x_te.dtype).removeprefix("torch."),
               "n_train": int(x_tr.shape[0]), "n_test": int(x_te.shape[0]),
               **profile_phase(fn, device, args.reps)}
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
