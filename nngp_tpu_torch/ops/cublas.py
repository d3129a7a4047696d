"""cuBLAS's triangular solve on PyTorch's own handle, for a factor read in
place: the leading (k, k) block of a (p, p) factor, a view whose columns
(the exact fit's column-major storage) or rows lie p elements apart,
solved with L (`trsm_lower`) or L^T (`trsm_lower_t`).

`torch.linalg.solve_triangular` takes a matrix whose rows or columns are
contiguous, and copies any other view into a new (k, k) tensor before it
calls cuBLAS; cuBLAS itself takes any leading dimension. At the padded
exact predict's live order (`gp.posterior.live_rows`: 11,008 of 14,896
rows in fp64 on synth6) that copy would be ~1 GB a predict, and a k^2
buffer in every serving bucket's CUDA graph pool. `trsm_lower` hands
cuBLAS the view's own memory instead (lda = p).

The library is the libcublas that PyTorch has loaded, found in the
process's mappings and opened with RTLD_NOLOAD (`mapped_library`, which
`ops/cusolver.py` shares), so that no second copy is ever loaded; the
handle is PyTorch's current one
(`torch.cuda.current_blas_handle()`), which carries the current stream, a
graph capture's included, and PyTorch's capture-safe workspace. Nothing
here runs until the first call on a CUDA tensor.
"""

import ctypes
import os
import threading

import torch

# cuBLAS's enums (cublas_api.h)
_SIDE_LEFT, _DIAG_NON_UNIT = 0, 0
_FILL_LOWER, _FILL_UPPER = 0, 1
_OP_N, _OP_T = 0, 1
_POINTER_MODE_HOST = 0
_TRSM = {torch.float64: ("cublasDtrsm_v2", ctypes.c_double),
         torch.float32: ("cublasStrsm_v2", ctypes.c_float)}
_TRSM_ARGTYPES = [
    ctypes.c_void_p,                                   # handle
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # side, uplo,
                                                       # trans, diag
    ctypes.c_int, ctypes.c_int,                        # m, n
    ctypes.c_void_p,                                   # alpha (host)
    ctypes.c_void_p, ctypes.c_int,                     # A, lda
    ctypes.c_void_p, ctypes.c_int,                     # B, ldb
]

_lock = threading.Lock()
_lib = None


def mapped_library(stem: str) -> ctypes.CDLL:
    """The library `stem` ('libcublas', 'libcusolver') that PyTorch has
    mapped into this process, found in the process's mappings and opened
    with RTLD_NOLOAD: never a second copy. RuntimeError where none is
    mapped."""
    with open("/proc/self/maps") as f:
        paths = {parts[5].strip() for parts in
                 (line.split(maxsplit=5) for line in f) if len(parts) == 6}
    found = sorted(p for p in paths
                   if os.path.basename(p).startswith(stem + ".so"))
    if not found:
        raise RuntimeError(
            f"no {stem} is mapped into this process: PyTorch's CUDA build "
            "links it statically or has not loaded it, and this module "
            "calls the copy PyTorch uses, never a second one")
    return ctypes.CDLL(found[0], mode=os.RTLD_NOLOAD | os.RTLD_LAZY)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = mapped_library("libcublas")
            for name, _ in _TRSM.values():
                fn = getattr(lib, name)
                fn.argtypes = _TRSM_ARGTYPES
                fn.restype = ctypes.c_int
            lib.cublasSetPointerMode_v2.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
            lib.cublasSetPointerMode_v2.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(status: int, call: str):
    if status != 0:
        raise RuntimeError(f"{call} failed: cublasStatus_t {status}")


def trsm_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b on the card for a lower-triangular (k, k) L whose rows, or
    columns, are contiguous and lie >= k elements apart (the leading block
    of a larger factor, read in place) and a (k, m) b of L's dtype, fp32
    or fp64: a new (k, m) tensor, column-major, as
    `torch.linalg.solve_triangular` returns it. Only L's lower triangle is
    read. Enqueued on the current stream; b is not modified."""
    return _trsm(l, b, transpose=False)


def trsm_lower_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-T b, as `trsm_lower` solves L^-1 b: the same L, read in place."""
    return _trsm(l, b, transpose=True)


def _trsm(l, b, transpose):
    k = l.shape[0]
    if l.dim() != 2 or l.shape[1] != k or l.device.type != "cuda" \
            or l.dtype not in _TRSM:
        raise ValueError(f"trsm_lower takes a square fp32 / fp64 CUDA L, "
                         f"got {tuple(l.shape)} {l.dtype} on {l.device}")
    # column-major, cuBLAS's order: L itself (lda = its column stride),
    # or for a row-major L the upper triangular L^T, op(A) = A^T = L
    if l.stride(0) == 1 and l.stride(1) >= max(k, 1):
        uplo, trans, lda = _FILL_LOWER, _OP_N, l.stride(1)
    elif l.stride(1) == 1 and l.stride(0) >= max(k, 1):
        uplo, trans, lda = _FILL_UPPER, _OP_T, l.stride(0)
    else:
        raise ValueError(f"trsm_lower reads L in place: its rows or columns "
                         f"must be contiguous, got strides {l.stride()}")
    if transpose:                   # op(A) = L^T
        trans = _OP_T if trans == _OP_N else _OP_N
    if b.dim() != 2 or b.shape[0] != k or b.dtype != l.dtype \
            or b.device != l.device:
        raise ValueError(f"b must be ({k}, m) {l.dtype} on {l.device}, got "
                         f"{tuple(b.shape)} {b.dtype} on {b.device}")
    # (m, k) row-major is B column-major with ldb = k: solved in place
    out = b.mT.clone(memory_format=torch.contiguous_format)
    m = out.shape[0]
    if k == 0 or m == 0:
        return out.mT
    name, scalar = _TRSM[l.dtype]
    lib = _library()
    alpha = scalar(1.0)
    with torch.cuda.device(l.device):
        handle = torch.cuda.current_blas_handle()
        _check(lib.cublasSetPointerMode_v2(handle, _POINTER_MODE_HOST),
               "cublasSetPointerMode_v2")
        _check(getattr(lib, name)(
            handle, _SIDE_LEFT, uplo, trans, _DIAG_NON_UNIT, k, m,
            ctypes.addressof(alpha), l.data_ptr(), lda, out.data_ptr(), k),
            name)
    return out.mT
