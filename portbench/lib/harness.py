"""One run of one cell: set-up, the measured window, the traced
sub-window when asked, the check against the reference, the result line.

The traffic mix's `kind` names its general runner (`kinds/<kind>.py`,
found by file name), which builds the system under test from the
configuration, offers the mix's load and judges the answers; everything
else here is common to every cell.
"""

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

from portbench.lib import registry
from portbench.reference import judge

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "nngp_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root):
    """Fixed build and kernel cache directories inside the checkout."""
    build = os.path.join(root, ".build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def scratch_dir():
    """Where a run writes its short-lived files: TMPDIR, else a fixed
    directory inside the checkout."""
    path = os.environ.get("TMPDIR") or os.path.join(registry.ROOT, ".build",
                                                    "tmp")
    os.makedirs(path, exist_ok=True)
    return path


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def runner_for(cell):
    return registry.kind(cell.mix["kind"], cell.root)


def process_cpu_s():
    """This process's CPU seconds, all threads."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def warm_profiler(torch):
    """One short profiler session, so that the traced run's own session
    starts without the tracer's first set-up (seconds on a card), which
    would otherwise stall the window."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        torch.ones(1).sum()
        if torch.cuda.is_available():
            (torch.ones(1, device="cuda") + 1).sum().item()


def launches():
    """The program's kernel launch counters, direct and in graph replays,
    by kernel and route."""
    from nngp_tpu_torch.ops import gram_cuda, matmul

    out = {}
    for launched, replayed in ((gram_cuda.LAUNCHES, gram_cuda.REPLAYS),
                               (matmul.LAUNCHES, matmul.REPLAYS)):
        for key in launched:
            out[key] = launched[key] + replayed.get(key, 0)
    return out


def log(*args):
    print("portbench:", *args, file=sys.stderr, flush=True)


def run_cell(cell, seed, seconds, trace, device, t_start, tmp_dir,
             config_overrides=None, mix_overrides=None, program=None,
             all_readings=None):
    """Run `cell` once and return the result object (the last line's
    keys, `check` last). `program` replaces the system under test (the
    control and the fault tests); config_overrides and mix_overrides
    change the configuration's and the mix's keys for this run;
    all_readings, a dict, gets every number the check read, those with
    no limit too."""
    import torch

    config = dict(cell.config, **(config_overrides or {}))
    mix = dict(cell.mix, **(mix_overrides or {}))
    run = SimpleNamespace(config=config, mix=mix, seed=seed,
                          device=torch.device(device), root=cell.root,
                          tmp_dir=tmp_dir, trace=bool(trace), log=log,
                          program=program)
    runner = runner_for(cell).Runner(run)
    if trace:
        warm_profiler(torch)
    runner.setup()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    before, cpu0, t_window = launches(), process_cpu_s(), time.perf_counter()
    out = runner.window(seconds)
    after, cpu1 = launches(), process_cpu_s()
    out.counts["launches_in_window"] = {
        k: after[k] - before[k] for k in after if after[k] != before[k]}
    # CPUs a second the run's process kept busy over the window: near 1,
    # the run is paced by one core (the interpreter's lock)
    out.counts["process_cpus"] = (cpu1 - cpu0) / (time.perf_counter()
                                                  - t_window)
    peak = (torch.cuda.max_memory_allocated()
            if run.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: modules of {found} are loaded in the "
                         "run's process")
    log("counts " + json.dumps(out.counts))
    metrics = {}
    if trace:
        ctx = SimpleNamespace(config=config, mix=mix, counts=out.counts,
                              spans=out.spans, traced=out.traced)
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        readings = dict(out.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in readings:
                metrics[m["name"]] = {"value": readings[m["name"]],
                                      "unit": m["unit"]}
    runner.release()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = runner.judge()
    log(f"reference check {time.perf_counter() - t_ref:.3f} s")
    log("readings " + json.dumps(readings))
    if all_readings is not None:
        all_readings.update(readings)
    ok, check = judge.verdict(readings, config["limits"])
    result = {"correct": bool(ok and out.failed == 0),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": {}}
    if run.device.type == "cuda":
        from portbench.lib.card import device_object

        result["device"] = dict(device_object(torch, cell.chips),
                                memory_peak_bytes=int(peak))
        if trace:
            result["device"]["busy_s"] = out.traced.busy_s
            result["device"]["window_s"] = out.traced.window_s
    if trace:
        result["breakdown"] = {
            "device_ops": out.traced.top_ops(),
            "idle_gaps": out.traced.idle_by_span(out.spans,
                                                 runner.IDLE_OUTSIDE)}
    result["check"] = check
    return result


def main(argv, t_start):
    args = parse_args(argv)
    cache_env(registry.ROOT)
    cell = registry.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; the benchmark "
                         "measures the card only")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"portbench: {args.workload} needs {cell.chips} "
                         f"cards, found {torch.cuda.device_count()}")
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda",
                      t_start, scratch_dir())
    for name, item in result["check"].items():
        print(f"check {name} {item['value']!r} limit {item['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
