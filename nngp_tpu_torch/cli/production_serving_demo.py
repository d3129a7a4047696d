"""End-to-end production serving lifecycle in one runnable script: the
counterpart of `examples/production_serving_demo.py`.

It walks the operations story around `est.predict(query_lines)` on a tiny
synthetic two-table schema, so it runs in seconds on the CPU and unchanged
on a GPU:

  1.  fit + checkpoint            Estimator(...).load_model() / save()
  2.  restart from disk           Estimator.restore()  (no refit)
  3.  warmup                      est.warmup()  (one predict: the kernel
                                  library's load and first allocations)
  4.  TCP serving                 EstimatorSocketServer + a socket client
  5.  uncertainty calibration     est.calibrate_uncertainty(feedback)
  6.  conformal intervals         est.predict_interval(lines)
  7.  online extension            est.extend_with_lines(feedback)
  8.  drift watch + remediation   est.record_feedback() -> DriftReport
  9.  hyper relearning            est.relearn_hyperparams()
  10. the same loop over the wire: labeled lines as feedback

    python -m nngp_tpu_torch.cli.production_serving_demo [--device cpu]

The JAX example warms one compiled program per serving bucket at step 3;
the port has no buckets (a CUDA launch takes any shape), so its warmup is
one predict.
"""

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np

from nngp_tpu_torch.featurize.stats import ColumnStats, TableStats
from nngp_tpu_torch.serve import Estimator, EstimatorSocketServer


def make_workload(tmp):
    """2-table schema + labeled queries in the serving grammar."""
    ta = TableStats("ta", (ColumnStats("id", "numerical", 0, 100),
                           ColumnStats("x", "numerical", -10, 10)),
                    chunk_size=8)
    tb = TableStats("tb", (ColumnStats("id", "numerical", 0, 100),
                           ColumnStats("y", "numerical", 0, 1)),
                    chunk_size=8)
    qdir = os.path.join(tmp, "queries")
    os.makedirs(qdir)
    rng = np.random.default_rng(0)

    def line(lo_scale=1.0):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        card = max(1, int(lo_scale * 1000 * (xu - xl)))
        return f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id@{card}"

    with open(os.path.join(qdir, "join_query_2.txt"), "w") as f:
        f.write("\n".join(line() for _ in range(120)) + "\n")
    # held-out labeled feedback (same distribution; more than the drift
    # monitor's 128-observation baseline warmup) + a DRIFTED batch (the
    # true cardinality function changed by 4x)
    feedback = [line() for _ in range(150)]
    drifted = [line(lo_scale=4.0) for _ in range(150)]
    return [ta, tb], qdir, feedback, drifted


def _ask(host, port, lines, replies):
    with socket.create_connection((host, port)) as c:
        c.sendall(("\n".join(lines) + "\n").encode())
        buf = b""
        while buf.count(b"\n") < replies:
            buf += c.recv(4096)
    return buf.decode().strip().splitlines()


def main(argv=None):
    p = argparse.ArgumentParser("nngp_tpu_torch production serving demo")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    args = p.parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="nngp_demo_")
    stats, qdir, feedback, drifted = make_workload(tmp)

    # -- 1. fit + checkpoint ------------------------------------------------
    est = Estimator("demo", data_path=None, train_query_path=qdir,
                    stats=stats, dtype=np.float64, verbose=False,
                    device=args.device)
    est.load_model(verbose=False)
    ckpt = os.path.join(tmp, "ckpt")
    est.save(ckpt)
    print(f"[1] fitted on {est.posterior.num_train} queries; "
          f"checkpoint -> {ckpt}")

    # -- 2. a server restart is a file load, not a refit --------------------
    est = Estimator.restore(ckpt, device=args.device)
    print("[2] restored from checkpoint")

    # -- 3. one predict before traffic ---------------------------------------
    est.warmup(max_batch=128, verbose=False)
    print("[3] warm (one predict of 128 rows)")

    # -- 4. TCP serving: newline queries in, JSON estimates out -------------
    test_lines = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id"]
    with EstimatorSocketServer(est, port=0) as srv:
        replies = _ask(srv.host, srv.port, test_lines, len(test_lines))
    for raw in replies:
        r = json.loads(raw)
        print(f"[4] served: mean={r['mean']:.2f} std={r['std']:.2f} "
              f"card~{r['card']:.0f}")

    # -- 5+6. calibrate on held-out feedback, then conformal intervals ------
    scale = est.calibrate_uncertainty(feedback, verbose=False)
    mean, lo, hi = est.predict_interval(test_lines, alpha=0.2)
    print(f"[5] calibrated std scale = {scale:.3f}")
    print(f"[6] 80% conformal card interval for line 0: "
          f"2^{lo[0]:.2f} .. 2^{hi[0]:.2f}")

    # -- 7. fold labeled feedback into the posterior (incremental) ----------
    n0 = est.posterior.num_train
    est.extend_with_lines(feedback)
    print(f"[7] extended {n0} -> {est.posterior.num_train} rows "
          f"(block-Cholesky append, no refit)")

    # -- 8. drift watch: healthy stream, then a drifted one -----------------
    rep = est.record_feedback(feedback)
    print(f"[8] in-distribution feedback: drift={rep.drift}")
    rep = est.record_feedback(drifted)
    print(f"[8] 4x-shifted workload:     drift={rep.drift} "
          f"(remediation hint: {rep.action})")

    # -- 9. remediate: relearn kernel hypers on the grown train set ---------
    if rep.drift:
        est.extend_with_lines(drifted)      # label + absorb the new regime
        est.relearn_hyperparams(steps=30, verbose=False)
        est.drift_monitor.reset()
        cardless = ["@".join(l.split("@")[:-1]) for l in drifted[:4]]
        mean2, _ = est.predict(cardless)
        print(f"[9] relearned hypers on {est.posterior.num_train} rows; "
              f"first drifted-query predictions now {np.round(mean2, 2)}")
    est.save(ckpt)                          # artifacts ride the checkpoint

    # -- 10. the same loop over the wire: labeled lines as feedback ----------
    # (feedback_mode='online': ack at once, monitor + extend in the
    # background; 'auto' also applies drift remediations)
    more = ["ta,tb@x,4.1,0.2@@ta,tb,id@3900", "ta,tb@x,7.7,1.0@@ta,tb,id@6700"]
    n0 = est.posterior.num_train
    with EstimatorSocketServer(est, port=0, feedback_mode="online",
                               feedback_flush_s=0.2) as srv:
        _ask(srv.host, srv.port, more + ["\\stats"], 3)
        deadline = time.monotonic() + 30
        while (est.posterior.num_train < n0 + 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        st = srv.stats()
    print(f"[10] wire feedback: {st['feedback_lines']} labeled lines -> "
          f"posterior {n0} -> {est.posterior.num_train} rows, "
          f"drift obs {est.drift_monitor.n}")
    if est.posterior.num_train < n0 + 2:
        raise SystemExit("[10] the wire feedback never reached the posterior")
    print("done")
    return est


if __name__ == "__main__":
    main(sys.argv[1:])
