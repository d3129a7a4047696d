"""cuSOLVER's Cholesky factor written over its own input: the leading (k, k)
block of a column-major (p, p) matrix, a view whose columns lie p elements
apart, factored in place (`potrf_lower_`).

`torch.linalg.cholesky_ex` hands cuSOLVER a column-major copy of its input,
returns a new tensor and zeroes its upper triangle out of place; with `out=`
it still computes into a temporary and copies. On the exact fit of 10,800
fp64 rows those copies took 3.6 ms of a fit's ~20 ms of device time
(PERF.md §5). cuSOLVER itself takes any leading dimension: `potrf_lower_`
calls potrf with uplo = lower and lda = p on the view's own memory, then
zeroes the strict upper triangle in place (PyTorch's `triu_` of the
transpose).

Only the column-major order is taken. A row-major lower triangle is the
column-major upper one, but cuSOLVER's upper potrf is another algorithm:
at 10,800 fp64 rows it took 24.5 ms against the lower one's 13.2 ms on an
H100 (PERF.md §6).

The library is the libcusolver that PyTorch has loaded
(`ops.cublas.mapped_library`: opened with RTLD_NOLOAD, never a second
copy), through its 64-bit API (`cusolverDnXpotrf`, as PyTorch calls it).
The handle is this module's own, one a device, bound to the current stream
at every call; the workspace comes from PyTorch's caching allocator, on
that stream; info stays on the device. Nothing here runs until the first
call on a CUDA tensor.
"""

import ctypes
import threading

import torch

from nngp_tpu_torch.ops.cublas import mapped_library

# cuBLAS's fill modes (cublas_api.h) and CUDA's data types (library_types.h)
_FILL_LOWER = 0
_DATA_TYPE = {torch.float32: 0, torch.float64: 1}      # CUDA_R_32F, _64F
_P, _I64, _SIZE = ctypes.c_void_p, ctypes.c_int64, ctypes.c_size_t
_ARGTYPES = {
    "cusolverDnCreate": [ctypes.POINTER(_P)],
    "cusolverDnCreateParams": [ctypes.POINTER(_P)],
    "cusolverDnSetStream": [_P, _P],
    # handle, params, uplo, n, type of A, A, lda, compute type, then the
    # device and host workspace sizes in bytes
    "cusolverDnXpotrf_bufferSize": [
        _P, _P, ctypes.c_int, _I64, ctypes.c_int, _P, _I64, ctypes.c_int,
        ctypes.POINTER(_SIZE), ctypes.POINTER(_SIZE)],
    # ..., then the device workspace and its size, the host's, and info
    "cusolverDnXpotrf": [
        _P, _P, ctypes.c_int, _I64, ctypes.c_int, _P, _I64, ctypes.c_int,
        _P, _SIZE, _P, _SIZE, _P],
}

_lock = threading.Lock()
_lib = None
_handles = {}               # device index -> (cusolverDnHandle_t, params)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = mapped_library("libcusolver")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(status: int, call: str):
    if status != 0:
        raise RuntimeError(f"{call} failed: cusolverStatus_t {status}")


def _handle(lib, device):
    """This device's handle and params, made on first use."""
    if device.index not in _handles:
        handle, params = _P(), _P()
        with torch.cuda.device(device):
            _check(lib.cusolverDnCreate(ctypes.byref(handle)),
                   "cusolverDnCreate")
            _check(lib.cusolverDnCreateParams(ctypes.byref(params)),
                   "cusolverDnCreateParams")
        _handles[device.index] = (handle, params)
    return _handles[device.index]


def potrf_lower_(a: torch.Tensor) -> torch.Tensor:
    """Factor the symmetric positive definite (k, k) `a` in place into its
    lower Cholesky factor L (a = L L^T), with cuSOLVER on the card: a is
    fp32 or fp64 on a CUDA device, its columns contiguous and >= k
    elements apart (the leading block of a larger column-major matrix,
    read and written in place). Only a's lower triangle is read; its
    strict upper triangle is zeroed. Returns info as a 0-dim int32 tensor
    on the device, not read here: 0, or the 1-based order of the leading
    minor that is not positive definite (cuSOLVER's and LAPACK's, as
    `torch.linalg.cholesky_ex` returns it), where a holds a partial
    factor. Enqueued on the current stream; allocates the workspace
    only."""
    k = a.shape[0] if a.dim() == 2 else -1
    if a.dim() != 2 or a.shape[1] != k or a.dtype not in _DATA_TYPE:
        raise ValueError(f"potrf_lower_ takes a square fp32 / fp64 matrix, "
                         f"got {tuple(a.shape)} {a.dtype}")
    if k > 1 and (a.stride(0) != 1 or a.stride(1) < k):
        raise ValueError(f"potrf_lower_ factors a in place in cuSOLVER's "
                         f"order: its columns must be contiguous, got "
                         f"strides {a.stride()}")
    if a.device.type != "cuda":
        raise ValueError(f"potrf_lower_ calls cuSOLVER: a must be on a CUDA "
                         f"device, got {a.device}")
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    if k == 0:
        return info
    lda, dtype = max(a.stride(1), k), _DATA_TYPE[a.dtype]
    with _lock, torch.cuda.device(a.device):
        lib = _library()
        handle, params = _handle(lib, a.device)
        _check(lib.cusolverDnSetStream(
            handle, torch.cuda.current_stream(a.device).cuda_stream),
            "cusolverDnSetStream")
        dev_bytes, host_bytes = _SIZE(), _SIZE()
        _check(lib.cusolverDnXpotrf_bufferSize(
            handle, params, _FILL_LOWER, k, dtype, a.data_ptr(), lda, dtype,
            ctypes.byref(dev_bytes), ctypes.byref(host_bytes)),
            "cusolverDnXpotrf_bufferSize")
        work = torch.empty(max(dev_bytes.value, 1), dtype=torch.uint8,
                           device=a.device)
        host = ctypes.create_string_buffer(max(host_bytes.value, 1))
        _check(lib.cusolverDnXpotrf(
            handle, params, _FILL_LOWER, k, dtype, a.data_ptr(), lda, dtype,
            work.data_ptr(), dev_bytes.value, host, host_bytes.value,
            info.data_ptr()), "cusolverDnXpotrf")
    # the strict upper triangle zeroed as the transpose's strict lower one:
    # PyTorch's in-place kernel walks the logical rows, which are a's
    # columns, contiguous (at 10,800 fp64 rows 0.56 ms, against 1.28 ms
    # for a.tril_() walking a's strided rows; PERF.md §6)
    a.mT.triu_()
    return info
