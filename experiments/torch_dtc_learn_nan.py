"""Where the batched fp32 DTC learn of synth6_big's best configuration goes
NaN, and on which linear-algebra route.

`chip_smoke.py` phase 12 (b) learns with `fit_kernel_hyperparams(x, y,
steps=100, max_points=None, ard=True, objective='dtc', dtc_m=512)` on
phase 8's 90,000-row chunk_norm fp32 split; its three restarts (initial
ridge 1e-3, 3e-2, 0.3) run as one batch. This runs the same learn once per
--arms entry and prints, for each restart, how many of its 101 loss
evaluations (100 steps and the final one) were not finite, which factor
failed first (K_mm, or C = psi psi^T + r I), its final loss, and the
winner's log evidence:

  cuda        as phase 12 runs it (torch's default CUDA route, cuSOLVER);
  cuda-magma  under torch.backends.cuda.preferred_linalg_library('magma');
  cuda-r0     the 1e-3 restart alone (reg_restarts=()), an unbatched factor;
  cpu         on the host (LAPACK), the rows and seeds unchanged.

    python experiments/torch_dtc_learn_nan.py --arms cuda,cuda-magma,cuda-r0,cpu

The cpu arm takes minutes on 8 cores; run it where the full 90,000 rows
fit in memory (about 10 GiB).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nngp_tpu_torch.gp import hyperopt  # noqa: E402

ARMS = ("cuda", "cuda-magma", "cuda-r0", "cpu")


class Recorder:
    """Wraps the DTC loss and `torch.linalg.cholesky_ex`: each evaluation's
    per-restart loss, and per-restart flags of the two factors' failures
    (K_mm first, then C, in the order the loss factors them)."""

    def __init__(self):
        self.losses, self.failed = [], []
        self._loss, self._chol = hyperopt._nll_dtc, torch.linalg.cholesky_ex
        self._infos = None

    def __enter__(self):
        def chol(a, *args, **kw):
            out = self._chol(a, *args, **kw)
            if self._infos is not None:
                self._infos.append((out.info > 0).reshape(-1).cpu().numpy())
            return out

        def loss(*args, **kw):
            self._infos = []
            val = self._loss(*args, **kw)
            self.losses.append(val.detach().cpu().numpy())
            self.failed.append(np.stack(self._infos))   # (2, R)
            self._infos = None
            return val

        hyperopt._nll_dtc, torch.linalg.cholesky_ex = loss, chol
        return self

    def __exit__(self, *exc):
        hyperopt._nll_dtc, torch.linalg.cholesky_ex = self._loss, self._chol

    def report(self, regs):
        losses, failed = np.stack(self.losses), np.stack(self.failed)
        for r, reg in enumerate(regs):
            bad = ~np.isfinite(losses[:, r])
            first = int(np.argmax(bad)) if bad.any() else None
            which = ("none" if first is None else
                     "+".join(name for name, f in
                              zip(("K_mm", "C"), failed[first, :, r]) if f)
                     or "neither factor (a NaN in the loss itself)")
            print(f"    restart {r} (initial ridge {reg:g}): "
                  f"{int(bad.sum())} of {len(losses)} evaluations not "
                  f"finite, the first at evaluation {first} ({which}); "
                  f"final loss {float(losses[-1, r])!r}")


def run_arm(arm, x_tr, y_tr):
    device = torch.device("cpu" if arm == "cpu" else "cuda")
    kw = {"reg_restarts": ()} if arm == "cuda-r0" else {}
    regs = (1e-3,) if arm == "cuda-r0" else (1e-3, 3e-2, 0.3)
    backend = None
    if arm == "cuda-magma":
        backend = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("magma")
    try:
        with Recorder() as rec:
            res, secs = chip_smoke.best_learn(x_tr, y_tr, device, **kw)
    finally:
        if backend is not None:
            torch.backends.cuda.preferred_linalg_library(backend)
    print(f"  {arm}: {secs!r} s, log evidence {float(res.log_evidence)!r}, "
          f"w={res.w!r} b={res.b!r} diag_reg={res.diag_reg!r}")
    rec.report(regs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default=",".join(ARMS))
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    if any(a not in ARMS for a in arms):
        ap.error(f"--arms: each of {ARMS}")
    if any(a != "cpu" for a in arms) and not torch.cuda.is_available():
        ap.error("the cuda arms need a GPU")
    print(chip_smoke.card_line() if torch.cuda.is_available()
          else "no GPU", flush=True)
    print(f"torch {torch.__version__}, {torch.get_num_threads()} CPU "
          "threads", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train, _ = chip_smoke.big_split(tmp)
        x_tr, y_tr = chip_smoke.encode_big(train)
    print(f"synth6_big train split {x_tr.shape} encoded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for arm in arms:
        run_arm(arm, x_tr, y_tr)
        sys.stdout.flush()


if __name__ == "__main__":
    main()
