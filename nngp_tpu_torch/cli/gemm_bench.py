"""Device times of the 3xTF32 GEMM's two kernels (the wgmma and narrow
routes of `ops/matmul.py`), built with compile-time variants, at the
Nystrom tier's shapes.

    python -m nngp_tpu_torch.cli.gemm_bench [--ablate] [--define NAME=FLAGS]
        [--shapes LABEL,...] [--reps N] [--out_dir DIR]

Builds `csrc/gemm_3xtf32.cu` alone with the library's nvcc flags once per
variant, every nvcc started together: `base` is the source as it is;
--ablate adds, for the wgmma kernel, `nosplit` (`-DGEMM_ABLATE=1`: the
split pass left out) and `1xtf32` (`-DGEMM_ABLATE=2`: one wgmma a k8
slice, big_a big_b, instead of three), and for the narrow kernel `stream`
(`-DNARROW_ABLATE=1`: the arithmetic left out, the ring of TMA copies
alone) and `narrow1x` (`-DNARROW_ABLATE=2`: one product a term, no
split), whose results are wrong and whose times show which phase sets the
kernel's; --define NAME=FLAGS adds a variant built with FLAGS
(space-separated nvcc flags); --shapes keeps only the named shapes
("panel b TN,predict mean NN": the narrow kernel's). Each variant is
timed on the wgmma route at the panel psi = K_pm W (16,384 x 2,048 x
2,048, NN), the panel C += psi^T psi (2,048 x 2,048 x 16,384, TN), the
8,192-row predict chunk's psi (NN) and the RPCholesky residual (65,536 x
64 x 2,112, NT), and on the narrow route at b += psi^T y (2,048 x 1 x
16,384, TN) and the predict's mean (8,192 x 1 x 2,048, NN), on N(0, 1)
operands from a fixed seed, in turns (every variant, then every variant
backwards):

  device_ms  the kernel's own device time a call (torch.profiler's CUDA
             records over --reps calls, `utils.profiling.kernel_device_ms`:
             CUDA events when the profiler keeps no record), one value a
             turn, with `device_ms_by` saying which;
  bound_ms   `utils.roofline.gemm_bound`: 3 x 2 M N K at 495 TFLOP/s (the
             H100 SXM's dense TF32 rate) or the bytes (A, B read once, C
             written once) at 3.35 TB/s, the larger; share = bound_ms /
             device_ms;
  err        (variants without GEMM_ABLATE) max |C - exact| / (|A| @ |B|)
             against fp64, beside torch.matmul fp32's.

Prints ptxas's registers, spills and advisories (C75xx: serialized or
waited wgmmas) for each variant's kernels, writes the whole nvcc report
of each to --out_dir, and one JSON line per variant. Needs a GPU.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from nngp_tpu_torch.ops import _build, matmul
from nngp_tpu_torch.utils.profiling import kernel_device_ms
from nngp_tpu_torch.utils.roofline import gemm_bound

# (label, m, n, k, A stored transposed, B stored transposed)
SHAPES = (("panel psi NN", 16384, 2048, 2048, False, False),
          ("panel C TN", 2048, 2048, 16384, True, False),
          ("predict psi NN", 8192, 2048, 2048, False, False),
          ("rpchol residual NT", 65536, 64, 2112, False, True),
          ("panel b TN", 2048, 1, 16384, True, False),
          ("predict mean NN", 8192, 1, 2048, False, False))
ABLATIONS = {"nosplit": ["-DGEMM_ABLATE=1"], "1xtf32": ["-DGEMM_ABLATE=2"],
             "stream": ["-DNARROW_ABLATE=1"], "narrow1x": ["-DNARROW_ABLATE=2"]}
KERNELS = {"wgmma": "gemm_3xtf32_wgmma_kernel",
           "narrow": "gemm_3xtf32_narrow_kernel"}


def operand(rows, cols, trans, gen):
    shape = (cols, rows) if trans else (rows, cols)
    t = torch.randn(shape, generator=gen, device="cuda")
    return t.mT if trans else t


def build(variants, out_dir):
    """{name: loaded library} of gemm_3xtf32.cu built once per variant,
    with ptxas's report of each printed and written to out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, flags in variants.items():
        so = os.path.abspath(os.path.join(out_dir, f"gemm_{name}.so"))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *flags, "-o", so,
               _build.GEMM_SOURCE]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        with open(os.path.join(out_dir, f"ptxas_{name}.txt"), "w") as f:
            f.write(report)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report[-4000:]}")
        lines = report.splitlines()
        ours = [i for i, line in enumerate(lines)
                if "Function properties" in line
                and any(k in line for k in KERNELS.values())]
        advice = sorted({line.split("(C75")[1][:2] for line in lines
                         if "(C75" in line and "gemm_3xtf32" in line})
        print(f"{name}: {' '.join(variants[name]) or '(as it is)'}; ptxas "
              f"advisories C75{', C75'.join(advice) if advice else ': none'}")
        for i in ours:
            wgmma = re.search(r"wgmma_kernelILi(\d+)ELb(\d)ELb(\d)E",
                              lines[i])
            if wgmma:
                bn, ta, tb = wgmma.groups()
                what = (f"wgmma BN {bn}, A{' transposed' * int(ta)}, "
                        f"B{' transposed' * int(tb)}")
            else:
                nb, ta, rows = re.search(
                    r"narrow_kernelILi(\d+)ELb(\d)ELi(\d+)E",
                    lines[i]).groups()
                what = (f"narrow R {rows}, NB {nb}, "
                        f"A{' transposed' * int(ta)}")
            print(f"  {what}: {lines[i + 1].strip()}; "
                  f"{lines[i + 2].split(': ')[-1]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.GEMM_ENTRY_POINTS:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = lib.gemm_3xtf32_setup()
        if err != 0:
            raise RuntimeError(f"{name}: gemm_3xtf32_setup: cudaError_t "
                               f"{err}")
        libs[name] = lib
    return libs


def errors(a, b, got):
    a64, b64 = a.double(), b.double()
    exact = a64 @ b64
    scale = torch.clamp_min(a64.abs() @ b64.abs(), 1e-300)
    return [float(((x.double() - exact).abs() / scale).max())
            for x in (got, a @ b)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--define", action="append", default=[],
                   help="NAME=FLAGS: a variant built with these nvcc flags")
    p.add_argument("--shapes", default="",
                   help="comma-separated labels of the shapes to time "
                        "(default: all)")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out_dir", default=os.path.join(".build", "gemm_bench"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_bench needs a GPU")
    variants = {"base": []}
    if args.ablate:
        variants.update(ABLATIONS)
    for item in args.define:
        name, _, flags = item.partition("=")
        variants[name] = flags.split()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    libs = build(variants, args.out_dir)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {}
    keep = [x for x in args.shapes.split(",") if x]
    unknown = set(keep) - {s[0] for s in SHAPES}
    if unknown:
        raise SystemExit(f"unknown shapes {sorted(unknown)}")
    for label, m, n, k, ta, tb in SHAPES:
        if keep and label not in keep:
            continue
        a, b = operand(m, k, ta, gen), operand(k, n, tb, gen)
        cases[label] = (a, b, torch.empty((m, n), device="cuda"))
    rows = {name: {} for name in libs}
    saved = _build._lib
    try:
        for name in [*libs, *reversed(libs)]:
            _build._lib = libs[name]
            for label, (a, b, c) in cases.items():
                route = "narrow" if b.shape[1] <= matmul.NARROW_MAX_N \
                    else "wgmma"

                def run():
                    return matmul._matmul_on_route(a, b, c, 1.0, 0.0, route)
                row = rows[name].setdefault(
                    label, {"route": route, "device_ms": [],
                            "device_ms_by": []})
                ms, by = kernel_device_ms(run, KERNELS[route], args.reps)
                row["device_ms"].append(ms)
                row["device_ms_by"].append(by)
                if "err" not in row and not any(
                        "ABLATE" in f for f in variants[name]):
                    row["err"], row["torch_matmul_err"] = errors(a, b, run())
    finally:
        _build._lib = saved
    for name, by_shape in rows.items():
        for label, row in by_shape.items():
            _, m, n, k, _, _ = next(s for s in SHAPES if s[0] == label)
            row["bound_ms"], row["bound_by"] = gemm_bound(m, n, k)
            row["share"] = row["bound_ms"] / min(row["device_ms"])
        print(json.dumps({"variant": name, "flags": variants[name],
                          "shapes": by_shape}))


if __name__ == "__main__":
    main()
