"""Active-learning CLI — PyTorch counterpart of
`nngp_tpu/cli/active_train.py`. The split is 20% train, 60% unlabeled
pool, 20% validation, seed 10.

    python -m nngp_tpu_torch.cli.active_train --device cuda \
        --query_path workloads/forest_data --budget 1000 --active_iters 3

Same flags and printed lines as the JAX CLI, plus --device (default cuda;
no fallback to the CPU). fp32 by default, fp64 with --x64. Flags whose path
is not ported stop with an error naming their ROADMAP item.
"""

import argparse
import os
import sys

import numpy as np

from nngp_tpu_torch.eval.splits import train_test_val_split
from nngp_tpu_torch.active import ActiveLearner
from nngp_tpu_torch.data.workload import (load_binary_join_workload,
                                          load_multi_join_workload,
                                          load_single_table_workload)
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.utils.device import resolve_device

# flag -> ROADMAP item that ports its path; setting one to anything but its
# default stops the CLI
_NOT_PORTED = {
    "mesh_devices": "Queue A #12 (parallel/)",
    "pad_acquisitions": "'Not to port' (shape buckets: a CUDA launch "
                        "takes any shape)",
}


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch active learner",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--kernel_type", type=str, default="nngp",
                   choices=["nngp", "ntk"])
    p.add_argument("--chunk_size", type=int, default=10)
    p.add_argument("--biased_sample", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--selection", type=str, default=None,
                   choices=["biased", "topk", "greedy"],
                   help="acquisition rule; default follows --biased_sample. "
                        "'greedy' = batch-diverse conditional-variance "
                        "selection (pivoted Cholesky of the pool posterior "
                        "covariance, active/greedy.py)")
    p.add_argument("--nystrom_grow", type=int, default=0,
                   help="with --nystrom_m: grow the inducing set by this "
                        "many rows per acquisition round (uniform subsample "
                        "of the acquired batch; O(n (m+s)^2) streamed refit "
                        "instead of the fixed-capacity moment extend)")
    p.add_argument("--active_iters", type=int, default=3)
    p.add_argument("--pad_acquisitions", action="store_true",
                   help="not ported")
    p.add_argument("--budget", type=int, default=1000)
    p.add_argument("--refit", type=str, default="incremental",
                   choices=["incremental", "full"])
    p.add_argument("--relations", type=str, default="forest")
    p.add_argument("--names", type=str, default="forest")
    p.add_argument("--schema_name", type=str, default=None,
                   help="multi-join schema; stats from "
                        "<query_path>/../<schema_name>_stats/")
    p.add_argument("--query_path", type=str, default="workloads/forest_data")
    p.add_argument("--data_path", type=str, default=None,
                   help="raw CSV dir (optional; stats fall back to the "
                        "query scan / stats JSON)")
    p.add_argument("--chunk_norm", action="store_true",
                   help="rescale packed categorical chunk slots onto the "
                        "[0,1000] numeric scale")
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--activation", type=str, default="relu",
                   choices=["relu", "erf"])
    p.add_argument("--diag_reg", type=float, default=1e-3)
    p.add_argument("--learn_hyper", action="store_true",
                   help="learn (w0, w, b, diag_reg) by evidence on the "
                        "initial train split before the acquisition loop "
                        "(gp.hyperopt); overrides --diag_reg")
    p.add_argument("--relearn_hyper", action="store_true",
                   help="relearn the hyperparameters after every "
                        "acquisition round, warm-started from the previous "
                        "optimum (full refit with the new spec that round); "
                        "implies --learn_hyper for the initial split")
    p.add_argument("--hyper_file", type=str, default=None,
                   help="learned-hyperparameter JSON artifact: load it if "
                        "it exists (skips the initial learning), else learn "
                        "and save it there")
    p.add_argument("--hyper_steps", type=int, default=100)
    p.add_argument("--hyper_points", type=int, default=4096,
                   help="hyperopt subsample; 0 = full train split (DTC "
                        "objective only)")
    p.add_argument("--ard", action="store_true",
                   help="with --learn_hyper: learn a per-feature input "
                        "scale (ARD); train/pool/val features are rescaled "
                        "by the learned vector")
    p.add_argument("--hyper_objective", type=str, default="auto",
                   choices=["auto", "exact", "dtc"],
                   help="which evidence --learn_hyper maximizes; auto = "
                        "dtc when --nystrom_m is set, else exact")
    p.add_argument("--x64", action="store_true", help="fp64")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--nystrom_m", type=int, default=None,
                   help="run the loop on the streaming Nystrom/DTC tier "
                        "with this many inducing rows (O(m^2) device "
                        "state at any n; exact moment extends per round)")
    p.add_argument("--nystrom_moments", type=str, default="fp32",
                   choices=["fp32", "df64"],
                   help="Nystrom moment precision: df64 = fp64 kernel "
                        "entries, bases, projections and accumulators "
                        "(fp32 posteriors)")
    return p


def reject_unported(p, args):
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) != p.get_default(flag):
            p.error(f"--{flag} is not ported yet (ROADMAP {item})")


def load_split(args):
    """The workload of --query_path encoded and split 20% train, 60% pool,
    20% validation (seed 10): (x_tr, y_tr, x_pool, y_pool, x_val, y_val,
    infos_val), numpy, fp64 with --x64 and fp32 otherwise. Prints the query
    count and the split shapes."""
    dtype = np.float64 if args.x64 else np.float32
    if args.schema_name:
        x, y, infos, _ = load_multi_join_workload(
            args.query_path, schema_name=args.schema_name,
            data_path=args.data_path, chunk_size=args.chunk_size,
            dtype=dtype, chunk_norm=args.chunk_norm)
    elif len(args.relations.split(",")) > 1:
        x, y, infos, _ = load_binary_join_workload(
            args.query_path, relations=args.relations, names=args.names,
            data_path=args.data_path, chunk_size=args.chunk_size,
            dtype=dtype, chunk_norm=args.chunk_norm)
    else:
        x, y, infos, _ = load_single_table_workload(
            args.query_path, relation=args.relations.split(",")[0],
            name=args.names.split(",")[0], data_path=args.data_path,
            chunk_size=args.chunk_size, dtype=dtype,
            chunk_norm=args.chunk_norm)
    print(f"number of query: {x.shape[0]}")
    (x_tr, y_tr, _i1, x_pool, y_pool, _i2,
     x_val, y_val, infos_val) = train_test_val_split(
        x, y, train_frac=0.2, test_frac=0.6, all_query_infos=infos)
    print(f"train {x_tr.shape}  pool {x_pool.shape}  val {x_val.shape}")
    return x_tr, y_tr, x_pool, y_pool, x_val, y_val, infos_val


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    reject_unported(p, args)
    device = resolve_device(args.device)
    x_tr, y_tr, x_pool, y_pool, x_val, y_val, infos_val = load_split(args)

    spec = KernelSpec(mlp(args.depth, args.width, args.activation))
    input_scale = None
    hyper_res = None
    if args.learn_hyper or args.relearn_hyper:
        if args.hyper_file and os.path.exists(args.hyper_file):
            from nngp_tpu_torch.gp.hyperopt import HyperoptResult
            res = HyperoptResult.load(args.hyper_file)
            print(f"loaded hyperparameters from {args.hyper_file}")
        else:
            from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams
            objective = args.hyper_objective
            if objective == "auto":
                objective = "dtc" if args.nystrom_m else "exact"
            if not args.hyper_points and objective != "dtc":
                raise SystemExit("--hyper_points 0 (full-n hyperopt) "
                                 "requires the DTC objective (exact loss "
                                 "is O(n^3)/step)")
            res = fit_kernel_hyperparams(
                x_tr, y_tr, depth=args.depth, activation=args.activation,
                get=args.kernel_type, steps=args.hyper_steps,
                max_points=args.hyper_points or None,  # 0 -> full n (dtc)
                width=args.width, ard=args.ard,
                objective=objective, dtc_m=min(512, args.nystrom_m or 512),
                device=device)
            if args.hyper_file:
                res.save(args.hyper_file)
                print(f"saved hyperparameter artifact to {args.hyper_file}")
        print(f"learned hyperparameters: w0={res.w0:.4f} w={res.w:.4f} "
              f"b={res.b:.4f} diag_reg={res.diag_reg:.3e} "
              f"({res.objective} log evidence {res.log_evidence:.2f})")
        spec = res.spec
        kw = res.fit_kwargs()
        args.diag_reg = kw["diag_reg"]
        input_scale = kw.get("input_scale")
        if args.relearn_hyper:
            # the learner owns feature scaling in relearn mode (each round
            # may produce a new ARD scale): hand it raw features
            hyper_res = res
        elif res.feature_scale is not None:
            s = res.feature_scale
            x_tr = x_tr * s.astype(x_tr.dtype)
            x_pool = x_pool * s.astype(x_pool.dtype)
            x_val = x_val * s.astype(x_val.dtype)
    join_workload = (bool(args.schema_name)
                     or len(args.relations.split(",")) > 1)
    learner = ActiveLearner(
        spec, budget=args.budget, active_iters=args.active_iters,
        kernel_type=args.kernel_type, biased_sample=args.biased_sample,
        selection=args.selection, diag_reg=args.diag_reg, refit=args.refit,
        nystrom_m=args.nystrom_m, nystrom_grow=args.nystrom_grow,
        nystrom_moments=args.nystrom_moments, input_scale=input_scale,
        relearn_hyper=hyper_res,
        hyper_points=args.hyper_points or None, hyper_ard=args.ard,
        partition_keys="num_table" if join_workload else "num_predicates",
        device=device)
    _post, history = learner.active_train(x_tr, y_tr, x_pool, y_pool,
                                          x_val, y_val, infos_val)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
