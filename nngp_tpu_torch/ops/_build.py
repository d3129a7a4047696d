"""Build and load the CUDA kernels: the Gram kernels (`csrc/gram.cu`) and
the 3xTF32 GEMMs (`csrc/gemm_3xtf32.cu`).

Each source is compiled by its own nvcc, all started together, with one
set of flags, and one link puts them into one shared library with a plain
C interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. -fmad=false is there for gram.cu's
epilogue, which rounds operation by operation as its plain twin does; in
the GEMM it touches only the fp32 epilogue (alpha * acc + beta * C), whose
unfused form is its twin's. The library is cached under
`.build/nngp_tpu_torch/` keyed by a hash of both sources and the flags, so
it is rebuilt whenever any of them changes. A build writes to a temporary
path and renames it into place, so a killed nvcc never leaves a
half-written library behind. `-Xptxas=-v` makes ptxas report each
kernel's registers, spills and shared memory; the build keeps that report
beside the library (`ptxas_report`).

There is no fallback: if nvcc is missing or the build fails, `load_library`
raises with nvcc's stderr.

The launch helpers that every kernel wrapper shares live here too: `ptr`
(a tensor's address, or NULL for None), `raise_on` (a launch's cudaError_t
raised) and the launch tally. A wrapper counts each launch with
`count(kind, launches)` into its own module's dict (`ops.gram_cuda.LAUNCHES`,
`ops.matmul.LAUNCHES`); inside `counting_into(counts)` this thread's
launches count into `counts` instead, whichever module made them
(`serve/graphs.py` captures a bucket's launches into its graph's tally so).
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
SOURCE = os.path.join(_PKG_DIR, "csrc", "gram.cu")
GEMM_SOURCE = os.path.join(_PKG_DIR, "csrc", "gemm_3xtf32.cu")
SOURCES = (SOURCE, GEMM_SOURCE)
BUILD_DIR = os.path.join(_REPO_ROOT, ".build", "nngp_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_SYM_ARGTYPES = [
    ctypes.c_void_p,                                  # x
    ctypes.c_int, ctypes.c_int, ctypes.c_int,         # n, d, ldx
    ctypes.c_void_p, ctypes.c_int,                    # traj, n_act
    ctypes.c_void_p, ctypes.c_void_p,                 # diag0, diag1
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # out0, out1, ldo
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # kinds, w2, b2
    ctypes.c_int, ctypes.c_int, ctypes.c_int,         # n_layers, want_ntk, max_blocks
    ctypes.c_void_p,                                  # stream
]
_CROSS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,       # x1, m, ld1
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,       # x2, n, ld2
    ctypes.c_int,                                      # d
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,    # traj1, traj2, n_act
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,    # out0, out1, ldo
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # kinds, w2, b2
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # n_layers, want_ntk, max_blocks
    ctypes.c_void_p,                                   # stream
]
_WGMMA_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # trans_a, trans_b, n64
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # m, n, k
    ctypes.c_float,                                    # alpha
    ctypes.c_void_p, ctypes.c_longlong,                # a, lda
    ctypes.c_void_p, ctypes.c_longlong,                # b, ldb
    ctypes.c_float,                                    # beta
    ctypes.c_void_p, ctypes.c_longlong,                # c, ldc
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # tiles, splits, k_split
    ctypes.c_int,                                      # blocks
    ctypes.c_void_p, ctypes.c_void_p,                  # work, counters
    ctypes.c_void_p,                                   # stream
]
_NARROW_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # trans_a, trans_b, nb
    ctypes.c_int,                                      # rows
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # m, n, k
    ctypes.c_float,                                    # alpha
    ctypes.c_void_p, ctypes.c_longlong,                # a, lda
    ctypes.c_void_p, ctypes.c_longlong,                # b, ldb
    ctypes.c_float,                                    # beta
    ctypes.c_void_p, ctypes.c_longlong,                # c, ldc
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # row_blocks, splits,
                                                       # k_split
    ctypes.c_int,                                      # clusters
    ctypes.c_void_p,                                   # stream
]
# the GEMM library's C entry points and their ctypes signatures
GEMM_ENTRY_POINTS = (("gemm_3xtf32_wgmma", _WGMMA_ARGTYPES),
                     ("gemm_3xtf32_narrow", _NARROW_ARGTYPES),
                     ("gemm_3xtf32_narrow_clusters", [ctypes.c_int] * 4),
                     ("gemm_3xtf32_setup", []))

_lock = threading.Lock()
_lib = None
_sink = threading.local()


def ptr(t):
    """A tensor's device address, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def raise_on(err: int, kernel: str):
    """Raise when a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")


@contextlib.contextmanager
def counting_into(counts: dict):
    """Count this thread's launches into `counts` (the keys of every
    wrapper's LAUNCHES) instead of the wrappers' own dicts while the block
    runs."""
    prev = getattr(_sink, "counts", None)
    _sink.counts = counts
    try:
        yield counts
    finally:
        _sink.counts = prev


def count(kind: str, launches: dict):
    """One launch of `kind` into the tally of `counting_into`, else into
    `launches` (the launching wrapper's LAUNCHES)."""
    counts = getattr(_sink, "counts", None)
    if counts is None:
        counts = launches
    counts[kind] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
        "kernels need the CUDA toolkit to build")


def library_path() -> str:
    digest = hashlib.sha256()
    for source in SOURCES:
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libkernels_{digest.hexdigest()[:16]}.so")


def is_built() -> bool:
    """Whether a library for the current source and flags is cached."""
    return os.path.exists(library_path())


def build() -> str:
    """Compile the library if the cached one is missing; return its path.
    One nvcc a source, all started together, then one link."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    procs = []
    try:
        for obj, source in zip(objs, SOURCES):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, source]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = []
        for cmd, proc in procs:
            _, err = proc.communicate(timeout=600)
            log.append(err)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}"
                    f"\n{err}")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        with open(f"{so}.log", "w") as f:
            f.write("".join(log))
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.unlink(path)
    return so


def ptxas_report(kernel: str):
    """ptxas's lines (registers, spills, shared memory, warnings) about the
    kernels whose names contain `kernel`, from the cached library's build
    log."""
    path = f"{library_path()}.log"
    if not os.path.exists(path):
        return []
    out, keep = [], False
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if kernel in line:
                keep = True
            elif not (line.startswith(" ") or ": Used " in line):
                keep = False
            if keep:
                out.append(line)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use. Loading it raises
    the GEMM kernels' dynamic shared-memory limit and reads the narrow
    kernel's resident clusters (`gemm_3xtf32_setup`), outside any CUDA
    graph capture."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in (("gram_sym_f32", _SYM_ARGTYPES),
                                   ("gram_sym_f64", _SYM_ARGTYPES),
                                   ("gram_cross_f32", _CROSS_ARGTYPES),
                                   ("gram_cross_f64", _CROSS_ARGTYPES),
                                   *GEMM_ENTRY_POINTS):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = lib.gemm_3xtf32_setup()
            if err != 0:
                raise RuntimeError(
                    f"gemm_3xtf32_setup failed: cudaError_t {err}")
            _lib = lib
        return _lib
