#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nngp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. The phases run in order and any failure
exits nonzero; nothing is caught and retried:

  1. card: the nvidia-smi name and power limit, and torch's device name;
  2. build: nvcc compiles `nngp_tpu_torch/csrc/gram.cu` for sm_90a into
     `.build/` (reused when the source hash matches);
  3. kernels vs their plain PyTorch twins on the card: fp32 and fp64, nngp
     and ntk, relu/erf/abs/sin, depth 1 and 3, b_std 0 and 0.1, at ragged
     sizes and at the forest shapes;
  4. the slice: the training CLI on the full forest workload (fp32 nngp,
     fp32 ntk, fp64 nngp) with the launch counters checked and the q-error
     held against the fp64 anchors of `tests/test_parity_gate.py`;
  5. times: warm fit and predict of the slice, the Cholesky and solves on
     their own, and each kernel against its plain twin at the forest shapes.

The last three lines are the card line, one JSON object with a summary per
kernel, and the result line `{"ok": true, "device": {...}}`. Without CUDA,
or outside a checkout, the script fails before printing any result.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

FOREST = "workloads/forest_data"
# fp64 (median, p95) of the symmetric q-error on the forest 10.8k/3.6k split
# (tests/test_parity_gate.py:72-90).
ANCHORS = {"nngp": (2.5962, 22.331), "ntk": (2.6333, 26.162)}
RAGGED_N, RAGGED_M, D = 1017, 333, 20
FOREST_N, FOREST_M = 10800, 3600
KERNELS = {  # name -> the Pallas kernel body it replaces
    "sym": ("gram_sym", "nngp_tpu/ops/gram_pallas.py:86"),
    "cross": ("gram_cross", "nngp_tpu/ops/gram_pallas.py:95"),
}
SOURCE = "nngp_tpu_torch/csrc/gram.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def inputs(n, seed, dtype, device):
    """(n, D) rows uniform in [0, 1000) from a seeded generator, with row 1
    zero and rows 2 and 3 one duplicated pair (rho = 1).

    The duplicated rows are constant 512: with D = 20 their self-product
    20 * 512^2 is exact in any summation order and K0 = 2^18 comes out
    exactly under both division and multiplication by 1/D, in fp32 and
    fp64. At rho = 1 the NTK and sin duals have unbounded slope, so a
    one-ulp difference in K0 between two correct summation orders would
    show there as ~1e-4 (fp32); an exact K0 lets the comparison see the
    epilogue's own handling of rho = 1 (the clip, acos(1))."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1000.0, (n, D))
    x[1] = 0.0
    x[2] = x[3] = 512.0
    return torch.as_tensor(x, dtype=dtype, device=device)


def check_close(label, got, want, dtype, get):
    """Elementwise bound: fp32 |k - plain| <= 2e-5 |plain| + 1e-3 (the
    bound of tests/test_gram_pallas.py:23); fp64 rtol 1e-10 for nngp and
    1e-7 for ntk (acos's slope at rho -> 1 turns a one-ulp difference in K0
    into ~1e-8 in theta). Returns the largest absolute difference."""
    if dtype == torch.float32:
        bound = 2e-5 * want.abs() + 1e-3
    else:
        bound = (1e-10 if get == "nngp" else 1e-7) * want.abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > bound
    if bool(bad.any()):
        i = int(torch.argmax((err - bound).flatten()))
        r, c = divmod(i, want.shape[1])
        raise AssertionError(
            f"{label}: {int(bad.sum())} entries out of tolerance; worst "
            f"[{r}, {c}] kernel {float(got[r, c])!r} plain "
            f"{float(want[r, c])!r}")
    return float(err.max())


def compare_sym(spec, x, label):
    """gram_sym vs gram_sym_plain for nngp+ntk and nngp alone, called as
    the fit calls it (exact diagonals passed in, the fit's ridge fused);
    the diagonal must be the exact recursion bit for bit and the output
    exactly symmetric. Returns the largest nngp difference."""
    from nngp_tpu_torch.gp.posterior import solve_ridge
    from nngp_tpu_torch.models.kernel_spec import diag_eval
    from nngp_tpu_torch.ops.gram_cuda import gram_sym, gram_sym_plain

    dn, dt = diag = diag_eval(spec.layers, x, ("nngp", "ntk"))
    reg = solve_ridge(diag)
    k, t = gram_sym(spec, x, ("nngp", "ntk"), diag_add=reg, diag=diag)
    torch.cuda.synchronize()
    pk, pt = gram_sym_plain(spec, x, ("nngp", "ntk"), diag_add=reg)
    err = check_close(f"{label} nngp", k, pk, x.dtype, "nngp")
    check_close(f"{label} ntk", t, pt, x.dtype, "ntk")
    if not (torch.equal(k.diagonal(), dn)
            and torch.equal(t.diagonal(), dt + reg)):
        raise AssertionError(f"{label}: diagonal is not the exact recursion")
    if not (torch.equal(k, k.mT) and torch.equal(t, t.mT)):
        raise AssertionError(f"{label}: output is not exactly symmetric")
    k1 = gram_sym(spec, x, "nngp", diag_add=reg)
    torch.cuda.synchronize()
    pk1 = gram_sym_plain(spec, x, "nngp", diag_add=reg)
    err = max(err, check_close(f"{label} nngp-only", k1, pk1, x.dtype,
                               "nngp"))
    if not torch.equal(k1.diagonal(), dn + reg):
        raise AssertionError(f"{label}: nngp-only diagonal is not exact")
    return err


def compare_cross(spec, x1, x2, label):
    from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_cross_plain

    k, t = gram_cross(spec, x1, x2, ("nngp", "ntk"))
    torch.cuda.synchronize()
    pk, pt = gram_cross_plain(spec, x1, x2, ("nngp", "ntk"))
    err = check_close(f"{label} nngp", k, pk, x1.dtype, "nngp")
    check_close(f"{label} ntk", t, pt, x1.dtype, "ntk")
    k1 = gram_cross(spec, x1, x2, "nngp")
    torch.cuda.synchronize()
    return max(err, check_close(f"{label} nngp-only", k1, pk, x1.dtype,
                                "nngp"))


def check_ragged(device):
    from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp

    n_cases = 0
    for dtype in (torch.float32, torch.float64):
        x = inputs(RAGGED_N, 0, dtype, device)
        x1 = inputs(RAGGED_M, 1, dtype, device)
        for act in ("relu", "erf", "abs", "sin"):
            for depth in (1, 3):
                for b_std in (0.0, 0.1):
                    spec = KernelSpec(mlp(depth, activation=act, b_std=b_std))
                    label = (f"{str(dtype)[6:]} {act} depth={depth} "
                             f"b_std={b_std}")
                    compare_sym(spec, x, f"sym {label}")
                    compare_cross(spec, x1, x, f"cross {label}")
                    n_cases += 1
    print(f"ragged kernel checks: {n_cases} (dtype, spec) cases, sym "
          f"n={RAGGED_N}, cross (m, n)=({RAGGED_M}, {RAGGED_N}), d={D}: all "
          "within tolerance")


def check_forest_shapes(device):
    """The slice's spec at the forest shapes; returns the fp32 nngp max
    abs differences {'sym': ..., 'cross': ...}."""
    from nngp_tpu_torch.models.kernel_spec import reference_kernel

    spec = reference_kernel()
    errs = {}
    for dtype in (torch.float32, torch.float64):
        x = inputs(FOREST_N, 2, dtype, device)
        x1 = inputs(FOREST_M, 3, dtype, device)
        e_sym = compare_sym(spec, x, f"sym forest {dtype}")
        e_cross = compare_cross(spec, x1, x, f"cross forest {dtype}")
        print(f"forest-shape kernel checks {str(dtype)[6:]}: sym "
              f"{FOREST_N}x{D} max|k-plain| {e_sym!r}, cross "
              f"{FOREST_M}x{FOREST_N} max|k-plain| {e_cross!r}")
        if dtype == torch.float32:
            errs = {"sym": e_sym, "cross": e_cross}
        del x, x1
        torch.cuda.empty_cache()
    return errs


def run_slice(argv):
    """One CLI run; returns (median, p95, launches) and echoes the CLI's
    headline lines (the per-partition profile is dropped)."""
    from nngp_tpu_torch.cli import train
    from nngp_tpu_torch.ops import gram_cuda

    for key in gram_cuda.LAUNCHES:
        gram_cuda.LAUNCHES[key] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    launches = dict(gram_cuda.LAUNCHES)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("train ", "[timing]", "memory:",
                            "Mean Square Error", "symmetric q-error")):
            print(f"  {line}")
    q = re.search(r"symmetric q-error: median=([0-9.]+) p95=([0-9.]+)", text)
    mse = re.search(r"Mean Square Error: ([0-9.eE+-]+)", text)
    if q is None or mse is None:
        raise AssertionError(f"CLI output lacks the q-error lines: {argv}")
    med, p95, mse = float(q.group(1)), float(q.group(2)), float(mse.group(1))
    if not all(np.isfinite([med, p95, mse])):
        raise AssertionError(f"non-finite q-error or MSE for {argv}")
    print(f"  launches {launches}")
    for key, count in launches.items():
        if count < 1:
            raise AssertionError(f"{argv}: the {key} kernel never launched")
    return med, p95, launches


def check_slice(device_name):
    runs = [("fp32 nngp", ["--kernel_type", "nngp"], "nngp", 0.01, 0.03),
            ("fp32 ntk", ["--kernel_type", "ntk"], "ntk", 0.01, 0.03),
            ("fp64 nngp", ["--kernel_type", "nngp", "--x64"], "nngp",
             2e-3, 2e-3)]
    first = None
    for label, extra, get, tol_med, tol_p95 in runs:
        print(f"slice {label}:")
        argv = ["--device", device_name, "--query_path", FOREST, *extra]
        med, p95, launches = run_slice(argv)
        a_med, a_p95 = ANCHORS[get]
        if abs(med / a_med - 1) > tol_med or abs(p95 / a_p95 - 1) > tol_p95:
            raise AssertionError(
                f"slice {label}: median {med} / p95 {p95} outside rel "
                f"{tol_med} / {tol_p95} of the fp64 anchors {a_med} / {a_p95}")
        if first is None:
            first = launches
    return first


def _event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps=10):
    """(kernel ms, plain ms) per call from CUDA events, after a warm-up of
    each, in the order plain, kernel, kernel, plain."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1 = _event_ms(plain_fn, reps)
    k1 = _event_ms(kernel_fn, reps)
    k2 = _event_ms(kernel_fn, reps)
    p2 = _event_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_kernels(device):
    """Each wrapper as the slice's nngp fit and predict call it, against
    its plain twin, at the forest shapes; returns the fp32 times."""
    from nngp_tpu_torch.gp.posterior import solve_ridge
    from nngp_tpu_torch.models.kernel_spec import diag_eval, reference_kernel
    from nngp_tpu_torch.ops.gram_cuda import (gram_cross, gram_cross_plain,
                                              gram_sym, gram_sym_plain)

    spec = reference_kernel()
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = inputs(FOREST_N, 2, dtype, device)
        x1 = inputs(FOREST_M, 3, dtype, device)
        diag = diag_eval(spec.layers, x, ("nngp", "ntk"))
        reg = solve_ridge(diag)
        times = {
            "sym": paired_ms(
                lambda: gram_sym(spec, x, "nngp", diag_add=reg, diag=diag),
                lambda: gram_sym_plain(spec, x, "nngp", diag_add=reg,
                                       diag=diag)),
            "cross": paired_ms(
                lambda: gram_cross(spec, x1, x, "nngp"),
                lambda: gram_cross_plain(spec, x1, x, "nngp")),
        }
        for key, (k_ms, p_ms) in times.items():
            print(f"time {KERNELS[key][0]} {str(dtype)[6:]} nngp: kernel "
                  f"{k_ms!r} ms, plain {p_ms!r} ms")
        if dtype == torch.float32:
            out = times
    return out


def time_slice(device):
    """Warm fit (Gram + Cholesky + alpha) and warm predict (mean + std of
    3.6k) of the fp32 nngp slice, host clock around synchronized work,
    median of 5; plus the Cholesky and the two alpha solves on their own."""
    from nngp_tpu_torch.cli import train
    from nngp_tpu_torch.gp import fit_gp
    from nngp_tpu_torch.models.kernel_spec import reference_kernel
    from nngp_tpu_torch.ops.gram_cuda import gram_sym

    args = train.build_parser().parse_args(["--query_path", FOREST])
    with contextlib.redirect_stdout(io.StringIO()):
        x_tr, y_tr, _, x_te, _, _ = train.load_split(args)
    spec = reference_kernel()
    x_te = torch.as_tensor(x_te, device=device)

    def fit():
        return fit_gp(spec, x_tr, y_tr, get="nngp", device=device)

    def host_ms(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    post = fit()
    fit_ms = host_ms(fit)
    predict_ms = host_ms(lambda: post.predict_mean_std(x_te))
    k = gram_sym(spec, post.x_train, "nngp", diag_add=post.reg)
    y_dev = post.y_train
    chol_ms = _event_ms(lambda: torch.linalg.cholesky(k), 3)
    solve_ms = _event_ms(lambda: torch.linalg.solve_triangular(
        post.l.mT, torch.linalg.solve_triangular(post.l, y_dev, upper=False),
        upper=True), 3)
    print(f"time slice fp32 nngp {x_tr.shape[0]} train / {x_te.shape[0]} "
          f"test: warm fit {fit_ms!r} ms, warm predict {predict_ms!r} ms; "
          f"inside the fit: cholesky {chol_ms!r} ms, alpha solves "
          f"{solve_ms!r} ms")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import nngp_tpu_torch  # noqa: F401  (fails outside a checkout)
    from nngp_tpu_torch.ops import _build
    from nngp_tpu_torch.utils.device import resolve_device

    card = card_line()
    print(card)
    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    cached = _build.is_built()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({'cached library' if cached else 'nvcc'})")

    check_ragged(device)
    errs = check_forest_shapes(device)
    launches = check_slice("cuda")
    print(f"times on {card}:")
    times = time_kernels(device)
    time_slice(device)

    summary = {"kernels": [
        {"name": KERNELS[key][0], "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[key][1], "launches": launches[key],
         "max_abs_err": errs[key], "ms": times[key][0],
         "plain_ms": times[key][1]}
        for key in ("sym", "cross")]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
