"""Times of the two CUDA Gram kernels at the main path's shapes, beside
their roofline bound and a cuBLAS yardstick.

    python -m nngp_tpu_torch.cli.gram_bench [--parent DIR] [--sass] [--reps N]

For each shape and dtype it times `gram_sym` as the fit calls it (nngp,
the exact diagonals and the ridge passed in) and `gram_cross` as the
predict calls it (nngp), from CUDA events over --reps launches after a
warm-up. The shapes are the main path's: forest (sym n = 10,800, cross
3,600 x 10,800, d = 20) in fp32 and fp64, and the synth6 width d = 61 in
fp32. Rows are uniform in [0, 1000) from a fixed seed.

  bound_ms   `utils.roofline.gram_bound`: max(bytes / 3.35 TB/s, dot
             FLOPs / 67 TFLOP/s), the H100 SXM's fp32 rate outside the
             tensor cores and its fp64 tensor-core rate;
             bytes = x read once + the output written once (the full n x n
             for sym); FLOPs = 2 d per distinct output (n (n + 1) / 2 for
             sym). `bound_by` names the larger term;
  device_ms  the kernel's own device time per call
             (`utils.profiling.kernel_device_ms`: torch.profiler's records,
             CUDA events over the whole call when it keeps none), with
             `device_ms_by` saying which; ms is the whole call from CUDA
             events (`utils.profiling.event_ms`), the wrapper's small torch
             ops (the input diagonal, the trajectories) included;
  share      bound_ms / ms;
  matmul_ms  torch.matmul(x1, x2.mT) in the kernel's dtype, at "highest"
             precision in fp32: cuBLAS writing the same output bytes from a
             dot of depth d. It is not the same
             function (no recursion, no diagonal); a yardstick only. The
             port never calls it.

--parent DIR also times the kernels of another checkout (the parent
commit unpacked with `git archive`), each run in its own process, in the
order parent, this, this, parent; a worker times and bounds with its own
checkout's `utils/profiling.py` and `utils/roofline.py`, so DIR must have
both. --ablate also times this checkout's
kernels built with `-DGRAM_ABLATE=1` (the recursion skipped), `=2` (the
global stores skipped) and `=3` (both): what is left of the time when a
phase is gone shows which phase sets it. --sass writes ptxas's register and
spill report and the SASS of the built library under --out_dir and prints
per-kernel instruction counts. Prints one JSON line per (checkout,
shape, dtype, kernel). Needs a GPU.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from nngp_tpu_torch.utils.profiling import event_ms, kernel_device_ms
from nngp_tpu_torch.utils.roofline import gram_bound

SHAPES = (("forest", 10800, 3600, 20, torch.float32),
          ("forest", 10800, 3600, 20, torch.float64),
          ("synth6", 10800, 3600, 61, torch.float32))


def rows(n, d, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 1000.0, (n, d)), dtype=dtype,
                           device="cuda")


def time_checkout(label, reps):
    """Time the kernels of the `nngp_tpu_torch` on sys.path; one JSON line
    each."""
    from nngp_tpu_torch.gp.posterior import solve_ridge
    from nngp_tpu_torch.models.kernel_spec import diag_eval, reference_kernel
    from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = reference_kernel()
    card = torch.cuda.get_device_name(0)
    for name, n, m, d, dtype in SHAPES:
        x = rows(n, d, 2, dtype)
        x1 = rows(m, d, 3, dtype)
        diag = diag_eval(spec.layers, x, ("nngp", "ntk"))
        reg = solve_ridge(diag)
        runs = {
            "gram_sym": ("sym", lambda: gram_sym(spec, x, "nngp",
                                                 diag_add=reg, diag=diag),
                         lambda: torch.matmul(x, x.mT), n),
            "gram_cross": ("cross", lambda: gram_cross(spec, x1, x, "nngp"),
                           lambda: torch.matmul(x1, x.mT), m),
        }
        for kernel, (kind, fn, mm, rows_out) in runs.items():
            fn(), mm()   # warm-up: the library's build, cuBLAS's handle
            ms = event_ms(fn, reps)
            dev_ms, dev_by = kernel_device_ms(fn, ("gram_", "kernel"), reps)
            b_ms, b_by = gram_bound(kind, rows_out, n, d, dtype)
            mm_ms = event_ms(mm, reps)
            print(json.dumps({
                "checkout": label, "kernel": kernel, "shape": name,
                "m": rows_out, "n": n, "d": d, "dtype": str(dtype)[6:],
                "ms": ms, "device_ms": dev_ms, "device_ms_by": dev_by,
                "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
                "matmul_ms": mm_ms, "card": card}),
                flush=True)
        del x, x1, diag
        torch.cuda.empty_cache()


def run_worker(root, label, reps, define=None):
    """This file's worker mode in a fresh process with `root` first on the
    import path, so it times that checkout's kernels (built with the nvcc
    flag `define` when given)."""
    env = dict(os.environ, PYTHONPATH=root)
    extra = [f"--define={define}"] if define else []
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", label,
         "--reps", str(reps), *extra], cwd=root, env=env,
        capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} worker failed:\n{proc.stderr[-3000:]}")


def sass_report(out_dir):
    """ptxas's resource report and per-kernel SASS instruction counts; the
    full report and listing go to out_dir."""
    from nngp_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_build.BUILD_DIR, "gram_report.cubin")
    proc = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
                           cubin, _build.SOURCE], capture_output=True,
                          text=True, timeout=600)
    with open(os.path.join(out_dir, "gram_ptxas.txt"), "w") as f:
        f.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(line.strip())
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.build()],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    with open(os.path.join(out_dir, "gram_sass.txt"), "w") as f:
        f.write(sass)
    functions = r"Function : (\S+)(.*?)(?=\n\s*Function : |\Z)"
    for func, body in re.findall(functions, sass, flags=re.S):
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
        row = {"function": func, "instructions": len(ins),
               "MUFU": sum("MUFU" in x for _, x in ins)}
        # the Dense-ReLU-Dense fp32 nngp kernels at forest's d = 20
        m = re.search(r"gram_kernelIfLb([01])ELb0ELi1E", func)
        if m:
            row["per_element"] = per_element(ins, sym=m.group(1) == "1")
        print(json.dumps(row))


def per_element(ins, sym, d=20, own=64, copies=21):
    """Estimated SASS instructions an output element executes, by phase,
    in the fp32 Dense-ReLU-Dense nngp kernel at d features. Each phase's
    innermost loop costs (its static size / the work instructions in it)
    per unit of work: a cp.async (`copies` per thread a tile: 20 x features
    and 1 trajectory), an FFMA of the dot (d per element; the dot's loop is
    the one with the most FFMA and no MUFU), three MUFU (the recursion of
    one element: rsqrt, acos, sqrt), an STG (one stored value; sym stores
    each element twice). K0 is the straight-line code from the dot loop to
    the barrier after its shared-memory stores, over the 64 elements
    (`own`) a thread holds."""
    addr = {int(a, 16): i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, x) in enumerate(ins):
        jump = re.search(r"BRA\s+(0x[0-9a-f]+)", x)
        if jump and int(jump.group(1), 16) < int(a, 16):
            loops.append((addr.get(int(jump.group(1), 16), i), i))
    inner = [(s, t) for s, t in loops
             if not any(s < s2 <= t2 < t for s2, t2 in loops)]

    def count(s, t, op):
        return sum(op in x for _, x in ins[s:t + 1])

    def unit_costs(op, per=1):
        return [(t - s + 1) * per / count(s, t, op) for s, t in inner
                if count(s, t, op)]

    dot = max(inner, key=lambda st: count(*st, "FFMA")
              if not count(*st, "MUFU") else -1)
    first_sts = next(i for i in range(dot[1], len(ins)) if "STS" in ins[i][1])
    after = next(i for i in range(first_sts, len(ins))
                 if "BAR.SYNC" in ins[i][1])
    stores = unit_costs("STG")
    out = {
        "stage": min(unit_costs("LDGSTS")) * copies / own,
        "dot": (dot[1] - dot[0] + 1) / count(*dot, "FFMA") * (d + (d & 1)),
        "k0": (after - dot[1]) / own,
        "recursion": min(unit_costs("MUFU", per=3)),
        "store": sum(stores) if sym else min(stores),
    }
    out["total"] = sum(out.values())
    return {k: round(v, 2) for k, v in out.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None,
                   help="another checkout whose kernels are timed beside")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--sass", action="store_true")
    p.add_argument("--out_dir", default=os.path.join(".build", "gram_bench"),
                   help="where --sass writes the ptxas report and listing")
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--define", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gram_bench needs a GPU", file=sys.stderr)
        return 1
    if args.worker:
        if args.define:
            from nngp_tpu_torch.ops import _build

            _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, args.define)
        time_checkout(args.worker, args.reps)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if args.sass:
        sass_report(args.out_dir)
    order = ([("parent", args.parent), ("this", root), ("this", root),
              ("parent", args.parent)] if args.parent else [("this", root)])
    for label, path in order:
        run_worker(os.path.abspath(path), label, args.reps)
    if args.ablate:
        for v in (1, 2, 3):
            run_worker(root, f"ablate={v}", args.reps, f"-DGRAM_ABLATE={v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
