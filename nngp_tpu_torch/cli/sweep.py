"""Kernel-architecture sweep: the counterpart of `nngp_tpu/cli/sweep.py`
("ntk kernel + depth/activation sweep (ReLU vs erf, 2-8 layers) on
forest").

    python -m nngp_tpu_torch.cli.sweep --device cuda \
        --query_path workloads/forest_data \
        --depths 1,2,4,8 --activations relu,erf --kernel_types nngp,ntk

Same flags, JSON rows and `SWEEP_SUMMARY` line as the JAX CLI, plus
--device (default cuda; no fallback to the CPU) and --x64 (fp64; the JAX
sweep runs in fp32 only). One row per configuration: the warm fit's
seconds, MSE, median / p95 symmetric q-error of the test split and the
exact GP log evidence. Every fit runs `gram_sym` and every predict
`gram_cross`, at the depth of the row.
"""

import argparse
import json
import sys

import numpy as np
import torch

from nngp_tpu_torch.data.workload import load_single_table_workload
from nngp_tpu_torch.eval.qerror import symmetric_qerror
from nngp_tpu_torch.eval.splits import train_test_val_split
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp.posterior import input_scale_for_bound
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.utils.device import resolve_device, working_dtype
from nngp_tpu_torch.utils.timing import sync, timed


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch kernel sweep",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--query_path", type=str, default="workloads/forest_data")
    p.add_argument("--relations", type=str, default="forest")
    p.add_argument("--depths", type=str, default="1,2,4,8")
    p.add_argument("--activations", type=str, default="relu,erf")
    p.add_argument("--kernel_types", type=str, default="nngp,ntk")
    p.add_argument("--diag_reg", type=float, default=1e-3)
    p.add_argument("--max_num_train", type=int, default=None)
    p.add_argument("--w_std", type=float, default=1.0)
    p.add_argument("--b_std", type=float, default=0.0)
    p.add_argument("--x64", action="store_true", help="fp64")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = np.float64 if args.x64 else np.float32
    x, y, infos, _ = load_single_table_workload(
        args.query_path, relation=args.relations, dtype=dtype)
    x_tr, y_tr, _, x_te, y_te, *_rest = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos,
        max_num_train=args.max_num_train)
    tdtype = working_dtype(args.x64)
    xd = torch.as_tensor(x_tr, dtype=tdtype, device=device)
    yd = torch.as_tensor(y_tr, dtype=tdtype, device=device)
    xt = torch.as_tensor(x_te, dtype=tdtype, device=device)
    y_true = np.asarray(y_te).ravel()
    max_abs = float(np.max(np.abs(x_tr))) if x_tr.size else 0.0

    results = []
    for depth in [int(d) for d in args.depths.split(",")]:
        for act in args.activations.split(","):
            spec = KernelSpec(mlp(depth, 512, act, args.w_std, args.b_std))
            # an explicit scale, as the JAX sweep passes one: the timed fit
            # then reads no data probe
            scale = input_scale_for_bound(max_abs, spec.layers,
                                          fp64=args.x64)
            for kt in args.kernel_types.split(","):
                post = fit_gp(spec, xd, yd, diag_reg=args.diag_reg, get=kt,
                              input_scale=scale)
                sync((post.l, post.alpha))
                _, fit_s = timed(
                    lambda: (lambda q: (q.l, q.alpha))(
                        fit_gp(spec, xd, yd, diag_reg=args.diag_reg, get=kt,
                               input_scale=scale)))
                mean, std = post.predict_mean_std(xt)
                sync((mean, std))
                errors = mean.cpu().numpy().ravel() - y_true
                q = symmetric_qerror(errors)
                row = {
                    "depth": depth, "activation": act, "kernel": kt,
                    "fit_s": round(fit_s, 4),
                    "mse": round(float(np.mean(errors ** 2)), 4),
                    "median_q": round(float(np.median(q)), 4),
                    "p95_q": round(float(np.quantile(q, 0.95)), 4),
                    # label-free architecture comparison: exact GP log
                    # evidence of the fitted model (free given the factor)
                    "log_evidence": round(
                        float(post.log_marginal_likelihood()), 2),
                }
                results.append(row)
                print(json.dumps(row), flush=True)
                del post, mean, std
    print("SWEEP_SUMMARY " + json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
