"""Where the time of the slice's warm phases goes: fit, predict, a
hyperparameter learn, a greedy selection, the Nystrom tier's fit and
predict, and a training epoch of two baselines.

    python -m nngp_tpu_torch.cli.profile_slice --device cuda \
        --query_path workloads/forest_data [--kernel_type ntk] [--x64] \
        [--phases fit,predict,hyperopt,hyperopt_warm,greedy]
    python workloads/unpack_synth6_big.py
    python -m nngp_tpu_torch.cli.profile_slice --device cuda \
        --schema_name synth6 --query_path workloads/synth6_big_data \
        --chunk_norm --nystrom_m 2048 [--nystrom_moments df64] \
        --phases nystrom_fit,nystrom_predict
    python -m nngp_tpu_torch.cli.profile_slice --device cuda \
        --query_path workloads/forest_data --phases baseline_dnn,baseline_ski
    python -m nngp_tpu_torch.cli.profile_slice --device cuda --x64 \
        --query_path workloads/forest_data --phases dist_fit,dist_predict \
        [--dist_block_size 256]

Takes the training CLI's flags (same workload, split, kernel and fit) plus
--reps and --phases. The phases:

  fit            fit_gp of the spec of --depth/--activation/--w_std/--b_std;
  predict        its predict_mean_std of the test split;
  hyperopt       fit_kernel_hyperparams on --hyper_points training rows,
                 --hyper_steps steps, the default 3 restarts (--ard: ARD);
  hyperopt_warm  the same with one restart, as a warm relearn runs;
  greedy         greedy_variance_select of GREEDY_K rows from the
                 covariance of the GREEDY_POOL test rows of largest std (with
                 --train_frac 0.2 --test_frac 0.6 the split is the active
                 learner's 20/60/20 one and the test split is its pool);
  nystrom_fit    fit_nystrom with --nystrom_m inducing rows and
                 --nystrom_moments on the train split (host numpy rows, as
                 the training CLI passes them);
  nystrom_predict  its predict_mean_std_chunked of the test split, 8,192
                 rows a chunk;
  baseline_dnn   one epoch of `train_multitask` (the DNN baseline) on the
                 train split at its default width (256 hidden units, batches
                 of 128, fp32), model set-up included;
  baseline_ski   one epoch (one full-batch Adam step: two SKI products
                 under autograd, one batched CG, one SLQ) of `train_dkl_ski`
                 at its defaults (256 hidden units, 100 x 100 grid, 8
                 probes, fp32);
  dist_fit       distributed_fit over a world-size-1 mesh (NCCL on a card,
                 gloo on the CPU) at --dist_block_size: the panel loop,
                 its broadcasts and all-gathers (NCCL kernels in `top`);
  dist_predict   its predict_mean_std of the test split.

After one cold call of each phase, for each phase:

  wall_ms     host clock around the synchronized call, median of --reps;
  busy_ms     the union of the device activity intervals (kernels, copies,
              fills) of one more call, traced by torch.profiler;
  idle        1 - busy_ms / the host-clock wall of that traced call (the
              tracer's host overhead counts as idle, so this is an upper
              bound);
  launches    the count of device activity records in the traced call;
  top         device ms per kernel name in the traced call, largest first;
  peak_gib    torch.cuda.max_memory_allocated over the traced call;
  step_ms     hyperopt phases: (wall_ms - the wall_ms of the same
              learn with 0 steps) / --hyper_steps, i.e. the step loop
              without the subsample and the final loss; baseline phases:
              wall_ms / the epoch's optimizer steps.

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

from nngp_tpu_torch.active import greedy_variance_select
from nngp_tpu_torch.baselines.trainer import train_multitask
from nngp_tpu_torch.cli import train
from nngp_tpu_torch.gp import fit_gp, fit_nystrom
from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams
from nngp_tpu_torch.models.ski import train_dkl_ski
from nngp_tpu_torch.utils.device import resolve_device, working_dtype

TOP_KERNELS = 8
# the hyperopt phases' ridge restarts beside init's 1e-3
HYPER_RESTARTS = {"hyperopt": (3e-2, 0.3), "hyperopt_warm": ()}
NYSTROM_PHASES = ("nystrom_fit", "nystrom_predict")
BASELINE_PHASES = ("baseline_dnn", "baseline_ski")
DIST_PHASES = ("dist_fit", "dist_predict")
PHASES = ("fit", "predict", *HYPER_RESTARTS, "greedy", *NYSTROM_PHASES,
          *BASELINE_PHASES, *DIST_PHASES)
# the DNN baseline's default minibatch
BASELINE_BATCH = 128
# the greedy phase's size: the active learner's pre-filtered slice and its
# budget on forest
GREEDY_POOL, GREEDY_K = 4096, 1000


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


def _median_wall_ms(fn, device, reps: int) -> float:
    return statistics.median(_wall_ms(fn, device) for _ in range(reps))


def profile_phase(fn, device, reps: int) -> dict:
    out = {"wall_ms": _median_wall_ms(fn, device, reps),
           "busy_ms": None, "idle": None, "launches": None, "top": None,
           "peak_gib": None}
    if device.type != "cuda":
        return out
    torch.cuda.reset_peak_memory_stats(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        traced_ms = _wall_ms(fn, device)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    # device activity only: an annotated range (e.g. an optimizer's step)
    # also shows on the device timeline and spans the gaps inside it
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        return out
    busy_ms = union_length((s, e) for _, s, e in spans) / 1e3
    per_name = collections.Counter()
    for name, start, end in spans:
        per_name[name] += (end - start) / 1e3
    out.update(busy_ms=busy_ms, idle=1.0 - busy_ms / traced_ms,
               launches=len(spans),
               top=[[name[:80], ms]
                    for name, ms in per_name.most_common(TOP_KERNELS)])
    return out


def main(argv=None):
    p = train.build_parser()
    p.add_argument("--reps", type=int, default=5,
                   help="timed calls per phase (the median is reported)")
    p.add_argument("--phases", type=str, default="fit,predict",
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--dist_block_size", type=int, default=256,
                   help="the dist_* phases' panel width")
    args = train.parse_args(p, argv)
    if args.profile_dir:
        p.error("--profile_dir: this tool traces each phase itself; write "
                "a trace of the training CLI's run with "
                "nngp_tpu_torch.cli.train --profile_dir")
    for flag in ("learn_hyper", "select_kernel", "hyper_file"):
        if getattr(args, flag) != p.get_default(flag):
            p.error(f"--{flag}: the fit and predict phases profile the "
                    "spec given by --depth/--activation/--w_std/--b_std, "
                    "the hyperopt phases a learn from the default init; "
                    "fit with learned hyperparameters through "
                    "nngp_tpu_torch.cli.train")
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        p.error(f"--phases: unknown {unknown}; choose from {PHASES}")
    if args.reps < 1:
        p.error("--reps must be >= 1")
    if set(phases) & set(HYPER_RESTARTS) and args.hyper_steps < 1:
        p.error("--hyper_steps must be >= 1 to profile a learn")
    if set(phases) & set(NYSTROM_PHASES) and not args.nystrom_m:
        p.error("--phases nystrom_*: give --nystrom_m")
    device = resolve_device(args.device)
    x_tr, y_tr, _, x_te, _, _ = train.load_split(args)
    spec = train.spec_from_args(args)
    dtype = working_dtype(args.x64)
    x_te = torch.as_tensor(x_te, dtype=dtype, device=device)
    xl = torch.as_tensor(x_tr, dtype=dtype, device=device)
    yl = torch.as_tensor(y_tr, dtype=dtype, device=device)

    def fit():
        return fit_gp(spec, x_tr, y_tr, diag_reg=args.diag_reg,
                      get=args.kernel_type, device=device)

    def learn(phase, steps):
        return lambda: fit_kernel_hyperparams(
            xl, yl, depth=args.depth, activation=args.activation,
            get=args.kernel_type, steps=steps, max_points=args.hyper_points,
            width=args.width, ard=args.ard,
            reg_restarts=HYPER_RESTARTS[phase])

    def fit_ny():
        return fit_nystrom(spec, x_tr, y_tr, num_inducing=args.nystrom_m,
                           diag_reg=args.diag_reg, get=args.kernel_type,
                           moments=args.nystrom_moments, device=device)

    fns = {**{ph: learn(ph, args.hyper_steps) for ph in HYPER_RESTARTS},
           "nystrom_fit": fit_ny,
           "baseline_dnn": lambda: train_multitask(
               x_tr, y_tr, epochs=1, batch_size=BASELINE_BATCH,
               device=device),
           "baseline_ski": lambda: train_dkl_ski(x_tr, y_tr, epochs=1,
                                                 device=device)}
    baseline_steps = {"baseline_dnn": -(-x_tr.shape[0] // BASELINE_BATCH),
                      "baseline_ski": 1}
    if set(phases) & {"fit", "predict", "greedy"}:
        post = fit()
        post.predict_mean_std(x_te)
        fns.update(fit=fit, predict=lambda: post.predict_mean_std(x_te))
    if "nystrom_predict" in phases:
        ny = fit_ny()
        fns["nystrom_predict"] = lambda: ny.predict_mean_std_chunked(x_te)
    if set(phases) & set(DIST_PHASES):
        from nngp_tpu_torch.parallel import distributed_fit, make_mesh

        mesh = make_mesh(1, device=args.device)

        def fit_dist():
            return distributed_fit(spec, x_tr, y_tr, mesh,
                                   diag_reg=args.diag_reg,
                                   get=args.kernel_type,
                                   block_size=args.dist_block_size)

        fns["dist_fit"] = fit_dist
        if "dist_predict" in phases:
            dpost = fit_dist()
            fns["dist_predict"] = lambda: dpost.predict_mean_std(x_te)
    if "greedy" in phases:
        _, std = post.predict_mean_std(x_te)
        top = torch.argsort(std, stable=True)[-GREEDY_POOL:]
        _, cov = post._predict_scaled(x_te[top], True)
        noise = post.reg.to(cov.dtype)
        fns["greedy"] = lambda: greedy_variance_select(cov, GREEDY_K, noise)
    records = []
    for phase in phases:
        fns[phase]()
        baseline = phase in BASELINE_PHASES      # fp32 whatever --x64
        rec = {"phase": phase,
               "kernel_type": None if baseline else args.kernel_type,
               "dtype": ("float32" if baseline
                         else str(x_te.dtype).removeprefix("torch.")),
               "n_train": int(x_tr.shape[0]), "n_test": int(x_te.shape[0]),
               **profile_phase(fns[phase], device, args.reps)}
        if phase in HYPER_RESTARTS:
            zero = learn(phase, 0)
            zero()
            rec["step_ms"] = (rec["wall_ms"] - _median_wall_ms(
                zero, device, args.reps)) / args.hyper_steps
        if baseline:
            rec["steps"] = baseline_steps[phase]
            rec["step_ms"] = rec["wall_ms"] / rec["steps"]
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
