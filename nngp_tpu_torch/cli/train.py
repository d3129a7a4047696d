"""Training / evaluation CLI — PyTorch counterpart of `nngp_tpu/cli/train.py`.

    python -m nngp_tpu_torch.cli.train --kernel_type nngp \
        --query_path workloads/forest_data --device cuda

Load the single-table or multi-join (--schema_name) workload -> seed-10
60/20/20 split -> [--learn_hyper / --select_kernel / --hyper_file
hyperparameters by evidence] -> [--select_reg ridge by evidence] -> fit
the exact GP (or with --nystrom_m the streaming Nystrom/DTC tier) on the
NNGP or NTK kernel -> report MSE, the partitioned q-error profile
and the symmetric q-error line. Same flags and printed lines as the JAX
CLI, plus --device (default cuda; no fallback to the CPU). fp32 by default,
fp64 with --x64 on either device.

Paths not ported yet stop with an error naming their ROADMAP item.
"""

import argparse
import os
import sys

import numpy as np
import torch

from nngp_tpu_torch.data.workload import (load_multi_join_workload,
                                          load_single_table_workload)
from nngp_tpu_torch.eval.qerror import (PredictionStatistics,
                                        qerror_profile, symmetric_qerror)
from nngp_tpu_torch.eval.splits import train_test_val_split
from nngp_tpu_torch.gp import fit_gp, fit_nystrom, select_diag_reg
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.utils.device import resolve_device, working_dtype
from nngp_tpu_torch.utils.timing import Timer

# flag -> ROADMAP item that ports its path; setting one to anything but its
# default stops the CLI
_NOT_PORTED = {
    "profile_dir": "Queue A #13 (utils/profiling.py)",
    "config": "Queue A #13 (utils/config.py)",
}


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch trainer",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--kernel_type", type=str, default="nngp",
                   choices=["nngp", "ntk", "gp"],
                   help="posterior semantics ('gp' is not ported yet)")
    p.add_argument("--chunk_norm", action="store_true",
                   help="rescale packed categorical chunk slots onto the "
                        "[0,1000] numeric scale")
    p.add_argument("--chunk_size", type=int, default=64,
                   help="factorized-encoding chunk width")
    p.add_argument("--relations", type=str, default="forest")
    p.add_argument("--names", type=str, default="forest")
    p.add_argument("--schema_name", type=str, default=None,
                   help="multi-join schema; stats from "
                        "<query_path>/../<schema_name>_stats/")
    p.add_argument("--query_path", type=str, default="workloads/forest_data")
    p.add_argument("--data_path", type=str, default=None,
                   help="raw CSV dir (not ported yet; stats come from the "
                        "query scan / stats JSON)")
    p.add_argument("--diag_reg", type=float, default=1e-3)
    p.add_argument("--select_reg", type=str, default=None,
                   help="comma-separated diag_reg candidates: fit each, keep "
                        "the one with the highest exact log evidence")
    p.add_argument("--nystrom_m", type=int, default=None,
                   help="fit the streaming Nystrom/DTC tier with this many "
                        "inducing rows instead of the exact posterior "
                        "(gp/nystrom.py): O(n m^2) flops, O(m^2) device "
                        "state")
    p.add_argument("--nystrom_moments", type=str, default="fp32",
                   choices=("fp32", "df64"),
                   help="Nystrom moment precision: df64 runs the kernel "
                        "entries, bases, projections and accumulators in "
                        "fp64 (fp32 posteriors only)")
    p.add_argument("--learn_hyper", action="store_true",
                   help="learn (w0, w, b, diag_reg) by evidence before "
                        "fitting (gp.hyperopt; multi-start Adam); overrides "
                        "--w_std/--b_std/--diag_reg with the learned values")
    p.add_argument("--hyper_file", type=str, default=None,
                   help="learned-hyperparameter JSON artifact "
                        "(gp.hyperopt.HyperoptResult, either package's): "
                        "if it exists, load it and skip learning; otherwise "
                        "learn (with --learn_hyper/--select_kernel) and "
                        "save it there")
    p.add_argument("--hyper_steps", type=int, default=100)
    p.add_argument("--hyper_points", type=int, default=4096,
                   help="training-row subsample the evidence is optimized "
                        "on; 0 = the full training set (DTC objective only)")
    p.add_argument("--ard", action="store_true",
                   help="with --learn_hyper: learn a per-feature input "
                        "scale; train and test features are rescaled by "
                        "the learned vector before the fit")
    p.add_argument("--hyper_objective", type=str, default="auto",
                   choices=["auto", "exact", "dtc"],
                   help="which evidence --learn_hyper maximizes: the exact "
                        "GP's or the Nystrom/DTC model's; auto = dtc with "
                        "--nystrom_m, else exact")
    p.add_argument("--select_kernel", action="store_true",
                   help="evidence-ranked model selection over (depth in "
                        "1..3) x (relu, erf) with learned hyperparameters "
                        "per structure (gp.hyperopt.select_kernel); "
                        "overrides --depth/--activation/--w_std/--b_std/"
                        "--diag_reg")
    p.add_argument("--depth", type=int, default=1, help="hidden layers")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--activation", type=str, default="relu",
                   choices=["relu", "erf"])
    p.add_argument("--w_std", type=float, default=1.0)
    p.add_argument("--b_std", type=float, default=0.0)
    p.add_argument("--x64", action="store_true", help="fp64")
    p.add_argument("--train_frac", type=float, default=0.6)
    p.add_argument("--test_frac", type=float, default=0.2)
    p.add_argument("--max_num_train", type=int, default=None)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--partition_keys", type=str, default=None,
                   help="q-error partition attributes (default: "
                        "num_predicates)")
    p.add_argument("--calibration", action="store_true",
                   help="print expected-vs-observed confidence levels")
    p.add_argument("--uneven_split", type=str, default=None,
                   help="skew train composition by these attributes "
                        "(e.g. num_predicates)")
    p.add_argument("--skew_ratio", type=float, default=0.5)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="not ported yet")
    p.add_argument("--config", type=str, default=None,
                   help="not ported yet")
    return p


def reject_unported(p, args):
    if args.kernel_type == "gp":
        p.error("--kernel_type gp is not ported yet (ROADMAP Queue A #11, "
                "models/gp_rbf.py)")
    if not args.schema_name and len(args.relations.split(",")) > 1:
        p.error("binary-join workloads (a comma in --relations) are not "
                "ported yet (ROADMAP Queue A #7: they need the CSV loaders)")
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) != p.get_default(flag):
            p.error(f"--{flag} is not ported yet (ROADMAP {item})")


def _memory_usage_gb(device) -> dict:
    """Host RSS (when psutil is installed) and, on CUDA, the device memory
    held by tensors: the keys of `nngp_tpu.utils.memory.memory_usage_gb`."""
    out = {}
    try:
        import psutil
        out["host_rss_gb"] = psutil.Process().memory_info().rss / 1024 ** 3
    except ImportError:
        pass
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        out[f"{name}:{device.index or 0}_gb"] = (
            torch.cuda.memory_allocated(device) / 1024 ** 3)
    return out


def load_split(args):
    """The workload of --query_path encoded and split as the flags say:
    (x_tr, y_tr, infos_tr, x_te, y_te, infos_te), numpy, fp64 with --x64
    and fp32 otherwise. Prints the query count and the split shapes."""
    dtype = np.float64 if args.x64 else np.float32
    if args.schema_name:
        x, y, infos, _enc = load_multi_join_workload(
            args.query_path, schema_name=args.schema_name,
            data_path=args.data_path, dtype=dtype, chunk_norm=args.chunk_norm)
    else:
        x, y, infos, _enc = load_single_table_workload(
            args.query_path, name=args.names.split(",")[0],
            data_path=args.data_path, chunk_size=args.chunk_size,
            dtype=dtype, chunk_norm=args.chunk_norm)
    print(f"number of query: {x.shape[0]}  feature dim: {x.shape[1]}")

    if args.uneven_split:
        from nngp_tpu_torch.eval.splits import uneven_train_test_split
        (x_tr, y_tr, infos_tr, x_te, y_te, infos_te, *_rest) = \
            uneven_train_test_split(
                x, y, all_query_infos=infos,
                skew_split_keys=args.uneven_split,
                train_frac=args.train_frac, skew_ratio=args.skew_ratio,
                seed=args.seed)
    else:
        (x_tr, y_tr, infos_tr, x_te, y_te, infos_te, *_rest) = \
            train_test_val_split(
                x, y, train_frac=args.train_frac, test_frac=args.test_frac,
                seed=args.seed, all_query_infos=infos,
                max_num_train=args.max_num_train)
    print(f"train {x_tr.shape}  test {x_te.shape}")
    return x_tr, y_tr, infos_tr, x_te, y_te, infos_te


def spec_from_args(args) -> KernelSpec:
    return KernelSpec(mlp(args.depth, args.width, args.activation,
                          args.w_std, args.b_std))


def learn_hyperparams(p, args, x_tr, y_tr, timer, device):
    """The HyperoptResult that --hyper_file, --select_kernel or
    --learn_hyper ask for (in that order of precedence), or None."""
    from nngp_tpu_torch.gp.hyperopt import (HyperoptResult,
                                            fit_kernel_hyperparams,
                                            select_kernel)

    if args.hyper_file and os.path.exists(args.hyper_file):
        # the learning costs minutes; the artifact is a small JSON
        res = HyperoptResult.load(args.hyper_file)
        print(f"loaded hyperparameters from {args.hyper_file} "
              f"(depth={res.depth} activation={res.activation} "
              f"{res.objective} log evidence {res.log_evidence:.2f})")
        return res
    if not (args.select_kernel or args.learn_hyper):
        return None
    # auto = the evidence of the tier that serves
    objective = args.hyper_objective
    if objective == "auto":
        objective = "dtc" if args.nystrom_m else "exact"
    dtc_m = min(512, args.nystrom_m or 512)
    if args.select_kernel:
        with timer.measure("kernel selection (evidence grid)"):
            res, _ranked = select_kernel(
                x_tr, y_tr, get=args.kernel_type, steps=args.hyper_steps,
                max_points=args.hyper_points, width=args.width,
                verbose=print, ard=args.ard, objective=objective,
                dtc_m=dtc_m, device=device)
        print(f"selected kernel: depth={res.depth} "
              f"activation={res.activation}")
        return res
    if not args.hyper_points and objective != "dtc":
        p.error("--hyper_points 0 (full-n hyperopt) requires the DTC "
                "objective (exact loss is O(n^3)/step)")
    with timer.measure("hyperparameter learning (MLL)"):
        return fit_kernel_hyperparams(
            x_tr, y_tr, depth=args.depth, activation=args.activation,
            get=args.kernel_type, steps=args.hyper_steps,
            max_points=args.hyper_points or None, width=args.width,
            init=(args.w_std, args.w_std, max(args.b_std, 0.1),
                  args.diag_reg), ard=args.ard, objective=objective,
            dtc_m=dtc_m, device=device)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    reject_unported(p, args)
    device = resolve_device(args.device)
    torch_dtype = working_dtype(args.x64)

    x_tr, y_tr, _, x_te, y_te, infos_te = load_split(args)

    timer = Timer(device)
    spec = spec_from_args(args)
    input_scale = None
    res = learn_hyperparams(p, args, x_tr, y_tr, timer, device)
    if res is not None:
        print(f"learned hyperparameters: w0={res.w0:.4f} w={res.w:.4f} "
              f"b={res.b:.4f} diag_reg={res.diag_reg:.3e} "
              f"({res.objective} log evidence {res.log_evidence:.2f} "
              f"on {res.num_points} rows)")
        spec = res.spec
        fit_kw = res.fit_kwargs()
        args.diag_reg = fit_kw["diag_reg"]
        input_scale = fit_kw.get("input_scale")
        if res.feature_scale is not None:
            s = res.feature_scale
            print(f"learned ARD feature scale: range "
                  f"[{s.min():.3g}, {s.max():.3g}]")
            x_tr = res.scale_inputs(x_tr)
            x_te = res.scale_inputs(x_te)
        if args.hyper_file and not os.path.exists(args.hyper_file):
            res.save(args.hyper_file)
            print(f"saved hyperparameter artifact to {args.hyper_file}")
    print("memory:", _memory_usage_gb(device))

    def _fit():
        # x_tr stays host numpy: the fp32 prescale probe is free there
        if args.nystrom_m:
            return fit_nystrom(spec, x_tr, y_tr, num_inducing=args.nystrom_m,
                               diag_reg=args.diag_reg, get=args.kernel_type,
                               input_scale=input_scale,
                               moments=args.nystrom_moments, device=device)
        return fit_gp(spec, x_tr, y_tr, diag_reg=args.diag_reg,
                      get=args.kernel_type, input_scale=input_scale,
                      device=device)

    if args.select_reg and args.nystrom_m:
        p.error("--select_reg selects on the exact posterior; drop "
                "--nystrom_m (the Nystrom tier has posterior.log_evidence())")
    if args.select_reg:
        cands = [float(v) for v in args.select_reg.split(",")]
        best, scores = select_diag_reg(spec, x_tr, y_tr, candidates=cands,
                                       get=args.kernel_type,
                                       input_scale=input_scale,
                                       device=device)
        for r, mll in sorted(scores.items()):
            tag = "  <-- selected" if r == float(best.diag_reg) else ""
            print(f"diag_reg={r:g}: log evidence {mll:.2f}{tag}")
        args.diag_reg = float(best.diag_reg)
        del best

    x_te_dev = torch.as_tensor(x_te, dtype=torch_dtype, device=device)
    # after --select_reg the kernels are already built and warm
    cold_label = ("kernel construction (fit: Gram + Cholesky, cold)"
                  if not args.select_reg else
                  "kernel construction (fit; warm — compiled during "
                  "--select_reg sweep)")
    with timer.measure(cold_label):
        post = _fit()
    with timer.measure("fit (warm)"):
        post = _fit()
    with timer.measure("inference (cold, incl. compile)"):
        mean, std = post.predict_mean_std(x_te_dev)
    with timer.measure("inference (warm)"):
        mean, std = post.predict_mean_std(x_te_dev)
    timer.report()
    print("memory:", _memory_usage_gb(device))

    mean = mean.cpu().numpy().ravel()
    y_true = np.asarray(y_te).ravel()
    mse = float(np.sum((mean - y_true) ** 2))
    print(f"Mean Square Error: {mse}")

    errors = mean - y_true
    stat = PredictionStatistics()
    stat.get_prediction_details(
        errors, infos_te, partition_keys=args.partition_keys or "num_predicates")
    q = symmetric_qerror(errors)
    print(f"symmetric q-error: median={np.median(q):.4f} "
          f"p95={np.quantile(q, 0.95):.4f} p99={np.quantile(q, 0.99):.4f} "
          f"max={np.max(q):.4f}")
    if args.calibration:
        from nngp_tpu_torch.eval.calibration import calibration_table
        table = calibration_table(y_true, mean, std.cpu().numpy().ravel())
        print("<" * 80)
        print("Calibration Result:")
        for level, observed in table.items():
            print(f"Expected/Observed Confidence Level={level}/{observed}")
        print(">" * 80)
    return qerror_profile(errors)


if __name__ == "__main__":
    main(sys.argv[1:])
