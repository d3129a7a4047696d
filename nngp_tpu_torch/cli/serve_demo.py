"""Serving demo — PyTorch counterpart of `nngp_tpu/cli/serve_demo.py` (the
reference's `neuroestimator/estimator_test.py`): build or restore an
Estimator, warm it up, strip the cards from a query file, predict, and
print shapes and latency.

    python -m nngp_tpu_torch.cli.serve_demo --device cuda --schema_name synth \
        --stats_dir workloads/synth_stats \
        --train_query_path workloads/synth_join_data \
        --test_query_file workloads/synth_join_data/join_query_2.txt

Same flags as the JAX demo plus --device (default cuda; no fallback to the
CPU). Flags whose path is not ported stop with an error naming their
ROADMAP item. --quality best fills chunk_norm, ARD hyperparameters learned
by evidence (the DTC evidence on the Nystrom tier), df64 Nystrom moments
in fp32 and a 10% calibration holdout for flags left unset. --nystrom_m
or --tier auto|nystrom serve from the streaming Nystrom/DTC tier.
"""

import argparse
import os
import sys
import threading
import time

# flag -> ROADMAP item that ports its path; setting one to anything but its
# default stops the demo
_NOT_PORTED = {
    "mesh_devices": "Queue A #12 (parallel/)",
    "pad_slots": "'Not to port' (shape buckets)",
}
_TIER_ITEMS = {"distributed": "Queue A #12 (parallel/)"}


def load_query_lines_without_card(path: str, limit=None):
    """Strip the trailing @card from labeled lines."""
    lines = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            lines.append(line.rsplit("@", 1)[0])
            if limit and len(lines) >= limit:
                break
    return lines


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch serving demo",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--schema_name", type=str, required=True)
    p.add_argument("--data_path", type=str, default=None,
                   help="raw CSV dir: the schema's stats from its CSVs "
                        "(or pass --stats_dir)")
    p.add_argument("--stats_dir", type=str, default=None,
                   help="dir of TableStats JSONs (serving without CSVs)")
    p.add_argument("--train_query_path", type=str, required=True)
    p.add_argument("--test_query_file", type=str, default=None,
                   help="required unless --listen is given")
    p.add_argument("--chunk_size", type=int, default=64)
    p.add_argument("--use_aux", action="store_true")
    p.add_argument("--q_error_threshold", type=float, default=100.0)
    p.add_argument("--coef_var_threshold", type=float, default=1.0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="save/restore checkpoint dir")
    p.add_argument("--streaming", action="store_true",
                   help="also drive the continuous-batching front-end with "
                        "concurrent clients and print qps/latency stats")
    p.add_argument("--stream_clients", type=int, default=8)
    p.add_argument("--stream_wait_ms", type=float, default=5.0)
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--nystrom_m", type=int, default=None,
                   help="serve from the streaming Nystrom/DTC tier with "
                        "this many inducing rows (O(m^2) device state at "
                        "any train-set size)")
    p.add_argument("--nystrom_moments", type=str, default=None,
                   choices=("fp32", "df64"),
                   help="Nystrom moment precision (df64 = fp64 kernel "
                        "entries, bases, projections and accumulators; "
                        "they ride through --ckpt)")
    p.add_argument("--pad_slots", type=int, default=None,
                   help="not ported (shape buckets)")
    p.add_argument("--learn_hyper", action="store_true",
                   help="learn (w0, w, b, diag_reg) by evidence before "
                        "fitting (gp/hyperopt.py); the learned spec rides "
                        "through --ckpt")
    # three-state flags (unset / --x / --no-x): --quality best fills only
    # unset ones
    p.add_argument("--ard", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="with --learn_hyper: learn a per-feature input "
                        "scale. Needs fp32-safe features: add --chunk_norm. "
                        "--no-ard forces it off under --quality best")
    p.add_argument("--chunk_norm", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="rescale packed categorical chunk slots onto the "
                        "[0,1000] numeric scale; --no-chunk_norm forces "
                        "the bit-exact reference encoding even under "
                        "--quality best")
    p.add_argument("--hyper_file", type=str, default=None,
                   help="learned-hyperparameter JSON artifact "
                        "(gp.hyperopt.HyperoptResult, written by either "
                        "package): if it exists, serve with it and skip "
                        "learning; with --learn_hyper and no such file, "
                        "learn then save it there")
    p.add_argument("--hyper_steps", type=int, default=100)
    p.add_argument("--hyper_points", type=int, default=4096,
                   help="hyperopt subsample")
    p.add_argument("--calibrate_file", type=str, default=None,
                   help="HELD-OUT labeled query file (query@...@card lines): "
                        "fit the MLE std recalibration + split-conformal "
                        "score set before serving; also prints a conformal "
                        "interval demo")
    p.add_argument("--interval_alpha", type=float, default=0.1,
                   help="with --calibrate_file: miscoverage level of the "
                        "demo conformal intervals (>= 1-alpha coverage)")
    p.add_argument("--feedback_mode", type=str, default="off",
                   choices=("off", "monitor", "online", "auto"),
                   help="with --listen: accept LABELED lines "
                        "(query@...@card) over the socket as serving "
                        "feedback — monitor drift, learn online, or "
                        "auto-remediate a drift alarm (relearn the "
                        "hyperparameters; on the Nystrom tier grow the "
                        "inducing set on the training log) "
                        "(serve/socket_server.py)")
    p.add_argument("--warmup_batch", type=int, default=4096,
                   help="with --listen: one predict of this many rows "
                        "before accepting connections, so the first "
                        "request pays no kernel build (0 disables)")
    p.add_argument("--quality", type=str, default="reference",
                   choices=["reference", "best"],
                   help="'best' fills chunk_norm, ARD evidence-learned "
                        "hyperparameters and a 10%% calibration holdout for "
                        "flags left unset")
    p.add_argument("--tier", type=str, default=None,
                   choices=["auto", "exact", "nystrom", "distributed"],
                   help="posterior-tier routing: 'auto' keeps the exact "
                        "tier while the train set fits the device "
                        "(Estimator exact_max_n) and serves from the "
                        "streaming Nystrom tier beyond; explicit values "
                        "force a tier ('distributed' is not ported yet). "
                        "Default: derive from --nystrom_m")
    p.add_argument("--calibrate_frac", type=float, default=None,
                   help="hold out this fraction of the training queries "
                        "and auto-calibrate uncertainty on them")
    p.add_argument("--listen_max_requests", type=int, default=None,
                   help="with --listen: stop after serving this many "
                        "requests (default: forever)")
    p.add_argument("--listen", type=str, default=None, metavar="HOST:PORT",
                   help="after loading, serve over TCP: one card-less query "
                        "line in, one JSON estimate out "
                        "(serve/socket_server.py)")
    return p


def reject_unported(p, args):
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) != p.get_default(flag):
            p.error(f"--{flag} is not ported yet (ROADMAP {item})")
    if args.tier in _TIER_ITEMS:
        p.error(f"--tier {args.tier} is not ported yet "
                f"(ROADMAP {_TIER_ITEMS[args.tier]})")


def stream(est, lines, clients, wait_ms):
    """`clients` threads each submit every line through one
    StreamingBatcher(est.predict); returns (seconds, stats, results)."""
    from nngp_tpu_torch.serve import StreamingBatcher

    results = [None] * clients
    with StreamingBatcher(est.predict, max_wait_ms=wait_ms) as server:
        def client(cid):
            results[cid] = server.predict(lines)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        st = server.stats()
    return dt, st, results


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if not args.test_query_file and not args.listen:
        p.error("--test_query_file is required unless --listen is given")
    reject_unported(p, args)

    from nngp_tpu_torch.serve import Estimator

    if args.ckpt and os.path.exists(os.path.join(args.ckpt, "meta.json")):
        print("restoring from checkpoint ...")
        est = Estimator.restore(args.ckpt, device=args.device)
    else:
        print("loading schema and training data ... This may take seconds ...")
        # None, not False, when --learn_hyper is absent: --quality best
        # fills only an unset flag
        learn_hyper = True if args.learn_hyper else None
        if args.hyper_file and os.path.exists(args.hyper_file):
            from nngp_tpu_torch.gp.hyperopt import HyperoptResult
            learn_hyper = HyperoptResult.load(args.hyper_file)
            print(f"serving with hyperparameters from {args.hyper_file}")
        est = Estimator(args.schema_name, args.data_path,
                        args.train_query_path,
                        chunk_size=args.chunk_size, use_aux=args.use_aux,
                        q_error_threshold=args.q_error_threshold,
                        coef_var_threshold=args.coef_var_threshold,
                        stats_dir=args.stats_dir, chunk_norm=args.chunk_norm,
                        learn_hyper=learn_hyper, hyper_ard=args.ard,
                        hyper_steps=args.hyper_steps,
                        hyper_points=args.hyper_points,
                        nystrom_m=args.nystrom_m,
                        nystrom_moments=args.nystrom_moments,
                        quality=args.quality,
                        calibrate_frac=args.calibrate_frac, tier=args.tier,
                        device=args.device)
        if (args.hyper_file and est.hyper_result is not None
                and not os.path.exists(args.hyper_file)):
            est.hyper_result.save(args.hyper_file)
            print(f"saved hyperparameter artifact to {args.hyper_file}")
        if args.ckpt:
            est.save(args.ckpt)
    est.load_model()

    if args.calibrate_file:
        with open(args.calibrate_file) as f:
            cal_lines = [l.strip() for l in f if l.strip()]
        scale = est.calibrate_uncertainty(cal_lines)
        if args.ckpt:
            est.save(args.ckpt)     # calibration artifacts ride the ckpt

    if args.listen:
        from nngp_tpu_torch.serve import EstimatorSocketServer
        host, _, port = args.listen.rpartition(":")
        alpha = args.interval_alpha if args.calibrate_file else None
        if args.warmup_batch:
            est.warmup(max_batch=args.warmup_batch)
        # train_log: the Nystrom tier's growth refits on the training
        # queries (read only when a growth runs)
        with EstimatorSocketServer(est, host=host or "127.0.0.1",
                                   port=int(port), alpha=alpha,
                                   feedback_mode=args.feedback_mode,
                                   train_log=args.train_query_path) as srv:
            print(f"serving on {srv.host}:{srv.port} "
                  f"(newline-delimited queries; JSON replies"
                  f"{'; conformal intervals' if alpha else ''}) — Ctrl-C "
                  "to stop", flush=True)
            try:
                last_report = time.monotonic()
                while True:
                    time.sleep(0.5)
                    st = srv.stats()
                    if (args.listen_max_requests is not None
                            and st["requests"] >= args.listen_max_requests):
                        break
                    if st["requests"] and time.monotonic() - last_report > 60:
                        last_report = time.monotonic()
                        print(f"served {st['requests']} requests over "
                              f"{st['batches']} batches "
                              f"(p95 {st['p95_latency_ms']:.1f} ms)",
                              flush=True)
            except KeyboardInterrupt:
                pass
            st = srv.stats()
            print(f"shutting down: served {st['requests']} requests over "
                  f"{st['batches']} batches", flush=True)
        return

    lines = load_query_lines_without_card(args.test_query_file, args.limit)
    t0 = time.perf_counter()
    mean, std = est.predict(lines)
    dt = time.perf_counter() - t0
    print(f"predicted {len(lines)} queries in {dt:.4f}s "
          f"({len(lines)/dt:.1f} q/s)")
    print("pred_mean shape", mean.shape, "pred_std shape", std.shape)
    print("first 5 (log2-card mean, std):")
    for m, s in list(zip(mean, std))[:5]:
        print(f"  {m:.3f}  {s:.3f}   (card ~ {2**float(m):.1f})")

    if args.calibrate_file:
        a = args.interval_alpha
        im, lo, hi = est.predict_interval(lines, alpha=a)
        print(f"\nconformal {100*(1-a):.0f}% cardinality intervals "
              f"(first 5; std_scale={scale:.3f}):")
        for m, l_, h in list(zip(im, lo, hi))[:5]:
            print(f"  card ~ {2**float(m):.1f}  in "
                  f"[{2**float(l_):.1f}, {2**float(h):.1f}]")

    if args.streaming:
        print(f"\nstreaming load: {args.stream_clients} concurrent clients, "
              f"coalescing window {args.stream_wait_ms} ms")
        dt, st, _ = stream(est, lines, args.stream_clients,
                           args.stream_wait_ms)
        total = args.stream_clients * len(lines)
        print(f"streamed {total} requests in {dt:.3f}s "
              f"({total/dt:.1f} q/s) over {st['batches']} device batches "
              f"(mean batch {st['mean_batch']:.0f})")
        print(f"latency p50 {st['p50_latency_ms']:.1f} ms  "
              f"p95 {st['p95_latency_ms']:.1f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
