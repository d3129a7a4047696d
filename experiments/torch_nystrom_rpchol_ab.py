"""Inducing-selection A/B for the port's Nystrom tier: seeded uniform vs
block RPCholesky (randomly pivoted Cholesky, near trace-optimal column
Nystrom). The counterpart of experiments/nystrom_rpchol_ab.py, with its
arguments and print format, and a --device flag.

Reports q-error and log evidence on a real workload at several m, and the
fit's wall clock (the selection included), in fp32.

Usage: python experiments/torch_nystrom_rpchol_ab.py \\
           [workload=forest|synth6|synth6_big] [max_train] [m_list] [get] \\
           [seeds] [--device cuda|cpu]

synth6_big reads workloads/synth6_big_data (python
workloads/unpack_synth6_big.py).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from nngp_tpu_torch.eval.qerror import symmetric_qerror  # noqa: E402
from nngp_tpu_torch.eval.splits import train_test_val_split  # noqa: E402
from nngp_tpu_torch.gp import fit_nystrom, nystrom  # noqa: E402
from nngp_tpu_torch.models.kernel_spec import reference_kernel  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("workload", nargs="?", default="forest",
                choices=("forest", "synth6", "synth6_big"))
ap.add_argument("max_train", nargs="?", type=int, default=10800)
ap.add_argument("m_list", nargs="?", default="512,2048")
ap.add_argument("get", nargs="?", default="nngp", choices=("nngp", "ntk"))
ap.add_argument("seeds", nargs="?", type=int, default=3)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
workload, max_train, get, n_seeds = (args.workload, args.max_train,
                                     args.get, args.seeds)
ms = [int(v) for v in args.m_list.split(",")]
device = torch.device(args.device)


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize()


if workload == "forest":
    from nngp_tpu_torch.data.workload import load_single_table_workload
    x, y, infos, _ = load_single_table_workload(
        "workloads/forest_data", relation="forest", name="forest",
        dtype=np.float32)
else:
    from nngp_tpu_torch.data.workload import load_multi_join_workload
    path = {"synth6": "workloads/synth6_join_data",
            "synth6_big": "workloads/synth6_big_data"}[workload]
    x, y, infos, _ = load_multi_join_workload(
        path, schema_name="synth6", dtype=np.float32, chunk_norm=True)
(x_tr, y_tr, _i, x_te, y_te, _it, *_r) = train_test_val_split(
    x, y, 0.6, 0.2, max_num_train=max_train, all_query_infos=infos)
yv = np.asarray(y_te).ravel()
spec = reference_kernel()
print(f"workload={workload} n_train={x_tr.shape[0]} n_test={len(yv)} "
      f"get={get} device={device}", flush=True)

for m in ms:
    for inducing in ("uniform", "rpchol"):
        meds, p95s, evs, tsel = [], [], [], []
        for seed in range(n_seeds):
            nystrom._BASES_CACHE.clear()
            sync()
            t0 = time.time()
            post = fit_nystrom(spec, x_tr, y_tr, num_inducing=m, get=get,
                               seed=seed, inducing=inducing, device=device)
            sync()
            t_fit = time.time() - t0
            mm, ss = post.predict_mean_std_chunked(x_te)
            q = symmetric_qerror(mm - yv)
            meds.append(np.median(q))
            p95s.append(np.quantile(q, 0.95))
            evs.append(post.log_evidence())
            tsel.append(t_fit)
            assert np.all(np.isfinite(ss))
            del post
        print(f"m={m} inducing={inducing}: median q "
              f"{np.mean(meds):.4f}+-{np.std(meds):.4f} "
              f"p95 {np.mean(p95s):.4f}+-{np.std(p95s):.4f} "
              f"log_ev {np.mean(evs):.1f} fit {np.mean(tsel):.2f}s "
              f"(seeds={n_seeds})", flush=True)
