"""Baseline-model training CLI. Port of `nngp_tpu/cli/train_baselines.py`.

    python -m nngp_tpu_torch.cli.train_baselines --model_type DNN \
        --query_path workloads/forest_data [--device cpu]

Model types: DNN (MultiTaskMLP), MCDropout, DeepEnsemble, Density, DKL
(exact-GP deep kernel), DKL-SKI (grid-interpolation / KISS-GP deep kernel),
GP (sklearn exact GP), KRR, MLP (sklearn), XGB (xgboost when installed, else
the sklearn HistGradientBoosting fallback), RBF-GP (the MLL-trained RBF GP
of `models/gp_rbf.py`, the training CLI's --kernel_type gp), MSCN
(single-table set convolution).

Same flags and printed lines as the JAX CLI, plus --device (default cuda; no
fallback to the CPU) and --seed (initial weights, minibatch order, dropout
masks and probes; 0, the trainers' default, is what the JAX CLI always
uses: some of these models land far apart from seed to seed, and a spread
over seeds is the only fair reading of them). The sklearn model types run
on the host with their own fixed seeds. --data_path takes the table
stats from the relation's raw CSV (`data/loaders.py`).
"""

import argparse
import random
import sys

import numpy as np
import torch

from nngp_tpu_torch.baselines.trainer import (
    krr_train_and_test,
    sklearn_gp_train_and_test,
    train_deep_ensemble,
    train_density,
    train_mc_dropout,
    train_mlp_regressor,
    train_multitask,
    xgb_train_and_test,
)
from nngp_tpu_torch.data.workload import (load_single_table_workload,
                                          single_table_stats)
from nngp_tpu_torch.eval.qerror import PredictionStatistics, symmetric_qerror
from nngp_tpu_torch.eval.splits import train_test_val_split
from nngp_tpu_torch.utils.device import resolve_device

MODEL_TYPES = ["DNN", "MCDropout", "DeepEnsemble", "Density", "DKL",
               "DKL-SKI", "GP", "KRR", "MLP", "XGB", "RBF-GP", "MSCN"]


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch baselines",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--model_type", type=str, default="DNN",
                   choices=MODEL_TYPES)
    p.add_argument("--relations", type=str, default="forest")
    p.add_argument("--names", type=str, default="forest")
    p.add_argument("--query_path", type=str, default="workloads/forest_data")
    p.add_argument("--data_path", type=str, default=None,
                   help="raw CSV dir (optional; stats fall back to the "
                        "query scan / stats JSON)")
    p.add_argument("--chunk_size", type=int, default=64)
    p.add_argument("--num_hid", type=int, default=256)
    p.add_argument("--max_classes", type=int, default=10)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=8e-5)
    p.add_argument("--decay_factor", type=float, default=0.85)
    p.add_argument("--decay_patience", type=int, default=10)
    p.add_argument("--coeff", type=float, default=1.0)
    p.add_argument("--max_num_train", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the device-side trainers")
    return p


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().ravel()


def _run_mscn(args, device):
    """Single-table MSCN set-convolution baseline: (predictions, labels,
    query infos) of the test split."""
    from nngp_tpu_torch.baselines.mscn_trainer import train_mscn_single
    from nngp_tpu_torch.featurize.mscn import MSCNSingleEncoder
    from nngp_tpu_torch.featurize.parser import load_single_table_queries

    stats = single_table_stats(args.relations.split(",")[0],
                               args.names.split(",")[0], args.query_path,
                               args.data_path, chunk_size=args.chunk_size)
    queries, cards, infos = load_single_table_queries(args.query_path, stats)
    enc = MSCNSingleEncoder(stats)
    batch, _mask = enc.encode_batch(queries)
    y = np.log2(np.asarray(cards, dtype=np.float64)).reshape(-1, 1)
    n = len(queries)
    idx = list(range(n))
    random.seed(10)
    random.shuffle(idx)
    n_tr = int(0.6 * n)
    n_te = int(0.2 * n)
    if args.max_num_train:
        n_tr = min(n_tr, args.max_num_train)
    te_slice = slice(int(0.6 * n), int(0.6 * n) + n_te)
    batch = batch[idx]
    yp = y[idx]
    model = train_mscn_single(
        batch[:n_tr], yp[:n_tr], epochs=args.epochs,
        batch_size=args.batch_size, lr=args.learning_rate,
        weight_decay=args.weight_decay, seed=args.seed, verbose=print,
        device=device, pred_hid_ch=args.num_hid, pred_out_ch=args.num_hid,
        mlp_hid_ch=args.num_hid)
    with torch.no_grad():
        pred = model(torch.as_tensor(batch[te_slice], dtype=torch.float32,
                                     device=device))
    return _host(pred), yp[te_slice].ravel(), [infos[i] for i in idx[te_slice]]


def _report(name, pred, y_true, infos_te):
    errors = pred - y_true
    print(f"{name} mean square error: {float(np.mean(errors ** 2)):.4f}")
    PredictionStatistics().get_prediction_details(
        errors, infos_te, partition_keys="num_table")
    q = symmetric_qerror(errors)
    print(f"symmetric q-error: median={np.median(q):.4f} "
          f"p95={np.quantile(q, 0.95):.4f}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    mt = args.model_type
    # the sklearn model types run on the host and need no device
    device = (None if mt in ("GP", "KRR", "MLP", "XGB")
              else resolve_device(args.device))
    if mt == "MSCN":
        _report("MSCN", *_run_mscn(args, device))
        return
    x, y, infos, _ = load_single_table_workload(
        args.query_path, relation=args.relations.split(",")[0],
        name=args.names.split(",")[0], data_path=args.data_path,
        chunk_size=args.chunk_size, dtype=np.float32)
    print(f"number of query: {x.shape[0]}")
    (x_tr, y_tr, _i1, x_te, y_te, infos_te, *_rest) = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos,
        max_num_train=args.max_num_train)
    print(f"train {x_tr.shape}  test {x_te.shape}")

    common = dict(num_hid=args.num_hid, epochs=args.epochs,
                  batch_size=args.batch_size, lr=args.learning_rate,
                  weight_decay=args.weight_decay,
                  decay_factor=args.decay_factor,
                  decay_patience=args.decay_patience, seed=args.seed,
                  verbose=print, device=device)

    if mt == "DNN":
        model = train_multitask(x_tr, y_tr, max_classes=args.max_classes,
                                coeff=args.coeff, **common)
        with torch.no_grad():
            pred = _host(model(x_te)[0])
    elif mt == "MCDropout":
        model = train_mc_dropout(x_tr, y_tr, **common)
        pred = _host(model.predict(
            x_te, torch.Generator(device=device).manual_seed(args.seed))[0])
    elif mt == "DeepEnsemble":
        ens = train_deep_ensemble(x_tr, y_tr, **common)
        pred = _host(ens.predict(x_te)[0])
    elif mt == "Density":
        model = train_density(x_tr, y_tr, **common)
        with torch.no_grad():
            pred = _host(model(x_te)[0])
    elif mt == "DKL":
        from nngp_tpu_torch.models.dkl import predict_dkl, train_dkl
        params = train_dkl(x_tr, y_tr, hid_dim=args.num_hid,
                           epochs=args.epochs, seed=args.seed, verbose=print,
                           device=device)
        pred = _host(predict_dkl(params, x_tr, y_tr, x_te)[0])
    elif mt == "DKL-SKI":
        from nngp_tpu_torch.models.ski import predict_dkl_ski, train_dkl_ski
        params = train_dkl_ski(x_tr, y_tr, hid_dim=args.num_hid,
                               epochs=args.epochs, seed=args.seed,
                               verbose=print, device=device)
        pred = _host(predict_dkl_ski(params, x_tr, y_tr, x_te)[0])
    elif mt == "GP":
        pred, _std = sklearn_gp_train_and_test(x_tr, y_tr, x_te)
    elif mt == "KRR":
        pred = krr_train_and_test(x_tr, y_tr, x_te)
    elif mt == "MLP":
        reg = train_mlp_regressor(x_tr, y_tr, num_hid=args.num_hid,
                                  epochs=args.epochs,
                                  batch_size=args.batch_size,
                                  lr=args.learning_rate,
                                  weight_decay=args.weight_decay)
        pred = reg.predict(x_te)
    elif mt == "XGB":
        pred = xgb_train_and_test(x_tr, y_tr, x_te)
    else:  # RBF-GP
        from nngp_tpu_torch.models import gp_rbf
        x_d, y_d, xt_d = (torch.as_tensor(a, device=device)
                          for a in (x_tr, y_tr, x_te))
        params = gp_rbf.train(x_d, y_d, num_steps=10, verbose=print)
        pred = _host(gp_rbf.predict(params, x_d, y_d, xt_d)[0])

    _report(mt, np.asarray(pred).ravel(), np.asarray(y_te).ravel(), infos_te)


if __name__ == "__main__":
    main(sys.argv[1:])
