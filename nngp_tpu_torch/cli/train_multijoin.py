"""MSCN / TreeLSTM multi-join baseline training CLI. Port of
`nngp_tpu/cli/train_multijoin.py`.

    python -m nngp_tpu_torch.cli.train_multijoin --model_type MSCN \
        --query_path workloads/synth_join_data \
        --stats_dir workloads/synth_stats [--device cpu]

Same flags and printed lines as the JAX CLI, plus --device (default cuda; no
fallback to the CPU). The table stats come from --stats_dir, laid out in the
table order of --schema_name where the port knows the schema
(`data/workload.py::SCHEMA_TABLES`), or from the schema's raw CSVs under
--data_path.
"""

import argparse
import random
import sys

import numpy as np
import torch

from nngp_tpu_torch.baselines.mscn_trainer import (plans_to_arrays,
                                                   to_device,
                                                   train_mscn_multi,
                                                   train_tree_lstm)
from nngp_tpu_torch.data.workload import schema_stats, schema_stats_from_csvs
from nngp_tpu_torch.eval.qerror import PredictionStatistics, symmetric_qerror
from nngp_tpu_torch.featurize.mscn import MSCNMultiEncoder
from nngp_tpu_torch.utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch multi-join baselines",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--model_type", type=str, default="MSCN",
                   choices=["MSCN", "TLSTM"])
    p.add_argument("--query_path", type=str, required=True)
    p.add_argument("--stats_dir", type=str, default=None)
    p.add_argument("--schema_name", type=str, default=None)
    p.add_argument("--data_path", type=str, default=None,
                   help="raw CSV dir of --schema_name's tables")
    p.add_argument("--chunk_size", type=int, default=10)
    p.add_argument("--num_hid", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=8e-5)
    p.add_argument("--train_frac", type=float, default=0.6)
    p.add_argument("--test_frac", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=10)
    return p


def _load_stats(args):
    if args.stats_dir:
        return schema_stats(args.schema_name, args.stats_dir)
    if args.data_path and args.schema_name:
        return schema_stats_from_csvs(args.schema_name, args.data_path,
                                      args.chunk_size)
    raise SystemExit("pass --stats_dir or (--schema_name and --data_path)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    stats = _load_stats(args)
    device = resolve_device(args.device)
    enc = MSCNMultiEncoder(stats, seed=args.seed)
    queries, cards, infos = enc.load_queries(args.query_path)
    y = np.log2(np.asarray(cards, dtype=np.float64)).reshape(-1, 1)
    n = len(queries)
    print(f"number of query: {n}")

    # the split's index math on a list of queries: a seeded shuffle of the
    # indices, then prefix slices
    idx = list(range(n))
    random.seed(args.seed)
    random.shuffle(idx)
    n_tr = int(args.train_frac * n)
    n_te = int(args.test_frac * n)
    te = slice(n_tr, n_tr + n_te)
    infos_te = [infos[i] for i in idx[te]]

    common = dict(epochs=args.epochs, batch_size=args.batch_size,
                  lr=args.learning_rate, weight_decay=args.weight_decay,
                  seed=args.seed, verbose=print, device=device)

    if args.model_type == "MSCN":
        (t, _tm), (p, _pm), (j, _jm) = enc.encode_batch(
            [queries[i] for i in idx])  # pad over the full set, then slice
        model = train_mscn_multi(
            t[:n_tr], p[:n_tr], j[:n_tr], y[idx][:n_tr],
            table_hid_ch=args.num_hid, table_out_ch=args.num_hid,
            pred_hid_ch=args.num_hid, pred_out_ch=args.num_hid,
            join_hid_ch=args.num_hid, join_out_ch=args.num_hid,
            mlp_hid_ch=args.num_hid, **common)
        te_arrays = (t[te], p[te], j[te])
    else:
        roots = [enc.encode_plan(*queries[i]) for i in idx]
        arrays = plans_to_arrays(roots)
        model, _ = train_tree_lstm(
            roots[:n_tr], y[idx][:n_tr],
            op_out_ch=args.num_hid // 2, meta_out_ch=args.num_hid // 2,
            pred_hid_ch=args.num_hid, pred_out_ch=args.num_hid,
            lstm_hid_ch=args.num_hid, mlp_hid_ch=args.num_hid, **common)
        te_arrays = tuple(a[te] for a in arrays)
    with torch.no_grad():
        pred = model(*to_device(te_arrays, device))

    pred = pred.cpu().numpy().ravel()
    errors = pred - y[idx][te].ravel()
    print(f"{args.model_type} mean square error: {np.mean(errors ** 2):.4f}")
    PredictionStatistics().get_prediction_details(
        errors, infos_te, partition_keys="num_table")
    q = symmetric_qerror(errors)
    print(f"symmetric q-error: median={np.median(q):.4f} "
          f"p95={np.quantile(q, 0.95):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
