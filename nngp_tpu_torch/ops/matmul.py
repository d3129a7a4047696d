"""The 3xTF32 tensor-core GEMMs (`csrc/gemm_3xtf32.cu`) and `mm`, the one
dispatch of the Nystrom tier's products.

    C = alpha * a @ b + beta * C        (fp32)

`precision='high'` in `gp/nystrom.py` is the counterpart of the JAX
package's `jax.default_matmul_precision('high')`: on the TPU a dot at
Precision.HIGH is bf16_3x (each fp32 operand split into a high and a low
bf16 part, the three large cross products summed); here the parts are
TF32, the same construction on the card's tensor cores:

    big = rna_tf32(x),  small = rna_tf32(x - big)
    a b ~= small_a big_b + big_a small_b + big_a big_b    (fp32 sums)

with ~3 * 2^-22 of |a b| per product, against bf16_3x's ~2^-16. The TF32
lives in the kernel's instructions: `torch.backends.cuda.matmul.allow_tf32`
stays False, as `utils/device.py` sets it.

`matmul_3xtf32` launches one of the file's two kernels for CUDA tensors (or
raises: there is no fallback to cuBLAS) and runs its plain twin
`matmul_3xtf32_plain` for CPU tensors. The route is decided from the shape
and the layout before the launch (`launch_plan`): 'wgmma', the Hopper
design (TMA, a producer warp, wgmma), for outputs wider than NARROW_MAX_N
columns whose operands TMA can address (`tma_stride`); 'mma', the first
design (mma.sync), for narrower outputs and for operands TMA cannot
address. A launch error on either route raises. The twin splits the
operands with `tf32_split`, a bit-exact emulation of `cvt.rna.tf32.f32` on
the int32 view, and sums the three products of fp32 `torch.matmul` (whose
products of TF32 parts are exact), small terms first. It does not
reproduce the kernels' summation order.

`LAUNCHES` counts kernel launches, as `ops.gram_cuda.LAUNCHES` does for
the Gram kernels: every launch under the key 'gemm', and under
'gemm_wgmma' or 'gemm_mma' by its route. A launch made while a CUDA graph
is built counts into the graph's own tally (`ops.gram_cuda.counting_into`),
and `REPLAYS` counts the launches that replays of such graphs ran
(`serve/graphs.py`).

The launch logic is plain Python, tested on the CPU: `operand_layout` reads
an operand's layout (row-major or transposed), row stride and whether its
tiles can be copied 16 bytes at a time from its strides and address;
`tma_stride` whether TMA can address it, and with which row stride;
`output_stride` checks the output; `launch_plan` picks the route and tile
shape and splits K over the SMs when the output has too few tiles to fill
them.
"""

import torch

from nngp_tpu_torch.ops import gram_cuda

ROUTES = ("wgmma", "mma")
LAUNCHES = {"gemm": 0, "gemm_wgmma": 0, "gemm_mma": 0}
# kernel runs by replays of captured CUDA graphs (serve/graphs.py)
REPLAYS = dict.fromkeys(LAUNCHES, 0)

BK = 32                       # the kernels' K-step
# tile shape -> (rows, columns) of its block tile, and its route: the
# Hopper kernel's 128 x 128 and 128 x 64 tiles, the first design's wide
# and narrow ones
TILES = {"wgmma": (128, 128), "wgmma_n64": (128, 64), "wide": (128, 64),
         "narrow": (128, 16)}
ROUTE_OF = {"wgmma": "wgmma", "wgmma_n64": "wgmma", "wide": "mma",
            "narrow": "mma"}
NARROW_MAX_N = 16             # outputs this narrow take the narrow tile
N64_MAX_N = 64                # wgmma outputs this narrow take 128 x 64
MIN_SPLIT_STEPS = 8           # K-steps a split runs at least
PRECISIONS = ("highest", "high")
_INT32_MAX = 2 ** 31 - 1
_RNA_HALF = 0x1000            # half of the 13 dropped mantissa bits' unit
_TF32_MASK = -0x2000          # 0xFFFFE000 as an int32


# ------------------------------------------------------------ plain twin
def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32` rounds: add half a unit of the dropped
    bits to the magnitude on the int32 view and clear them. Inf and NaN
    pass through."""
    bits = x.view(torch.int32)
    rounded = ((bits + _RNA_HALF) & _TF32_MASK).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: torch.Tensor):
    """(big, small) fp32 tensors of TF32 values: big = rna_tf32(x), small =
    rna_tf32(x - big), the kernel's split (x - big is exact in fp32)."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")
    x = x.contiguous()
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor, out=None,
                        alpha: float = 1.0, beta: float = 0.0):
    """Plain PyTorch version of `matmul_3xtf32`: the same split and the
    same three products, each an fp32 `torch.matmul`, summed small terms
    first."""
    _check_operands(a, b, out, beta)
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    prod = a_small @ b_big + a_big @ b_small + a_big @ b_big
    return _epilogue(prod, out, alpha, beta)


def _epilogue(prod, out, alpha, beta):
    """alpha * prod + beta * out (out not read when beta is 0), into out
    when given."""
    res = prod if alpha == 1.0 else alpha * prod
    if beta != 0.0:
        res = (out if beta == 1.0 else beta * out) + res
    if out is None:
        return res
    out.copy_(res)
    return out


# ---------------------------------------------------------- launch logic
def operand_layout(t: torch.Tensor, rows: int, cols: int):
    """(transposed, row stride, vec) of a logical (rows, cols) operand: not
    transposed when its columns are contiguous (stored row-major rows x
    cols), transposed when its rows are (stored cols x rows). A dimension
    of size 1 takes either stride. vec: the stored rows can be copied 16
    bytes at a time (a 16-byte aligned base and a row stride that is a
    multiple of 4, or a single stored row); where both layouts fit, the one
    that allows that. Raises for any other layout."""
    s0, s1 = t.stride()
    options = []
    if cols == 1 or s1 == 1:                        # stored rows x cols
        options.append((False, s0 if rows > 1 else cols, rows))
    if rows == 1 or s0 == 1:                        # stored cols x rows
        options.append((True, s1 if cols > 1 else rows, cols))
    if not options:
        raise ValueError(
            f"operand of shape {tuple(t.shape)} with strides {t.stride()} "
            "has neither contiguous rows nor contiguous columns")
    aligned = t.data_ptr() % 16 == 0
    best = None
    for trans, ld, stored_rows in options:
        vec = aligned and (stored_rows == 1 or ld % 4 == 0)
        if best is None or (vec and not best[2]):
            best = (trans, ld, vec)
    return best


def tma_stride(trans: bool, ld: int, vec: bool, rows: int, cols: int):
    """The row stride (in elements) to give TMA for a logical (rows, cols)
    operand read with `operand_layout`'s (trans, ld, vec), or None when TMA
    cannot address it: its base must be 16-byte aligned and its stored rows
    a multiple of 16 bytes apart and not overlapping (at least as far apart
    as a stored row is long). An operand with one stored row has no row
    stride of its own: it gets the first multiple of 4 at least that long."""
    stored_rows, stored_cols = (cols, rows) if trans else (rows, cols)
    if not vec:
        return None
    if stored_rows == 1:
        return -(-stored_cols // 4) * 4
    return ld if ld >= stored_cols else None


def output_stride(out: torch.Tensor, m: int, n: int) -> int:
    """The row stride of an (m, n) output whose columns are contiguous and
    whose rows do not overlap; raises otherwise."""
    s0, s1 = out.stride()
    if (n > 1 and s1 != 1) or (m > 1 and s0 < n):
        raise ValueError(f"out of shape {tuple(out.shape)} with strides "
                         f"{out.stride()} needs contiguous, non-overlapping "
                         "rows")
    return s0 if m > 1 else n


def launch_plan(m: int, n: int, k: int, sms: int, tma: bool = False):
    """(tile shape, output tiles, K splits, K range of a split) of one
    launch; `ROUTE_OF[shape]` is its kernel. `tma`: TMA can address both
    operands. The Hopper kernel ('wgmma', 128 x 128 tiles; 'wgmma_n64' for
    outputs at most N64_MAX_N columns wide) takes outputs wider than
    NARROW_MAX_N columns when `tma` and K is not empty; the first design
    takes the rest, in its narrow tile for outputs at most NARROW_MAX_N
    columns wide. When the tiles are fewer than the SMs, K is split so
    that about two blocks a SM run, each split at least MIN_SPLIT_STEPS
    K-steps long."""
    if n <= NARROW_MAX_N:
        shape = "narrow"
    elif tma and k > 0:
        shape = "wgmma_n64" if n <= N64_MAX_N else "wgmma"
    else:
        shape = "wide"
    bm, bn = TILES[shape]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // BK)
    splits = 1
    if tiles < sms and steps > 0:
        splits = max(1, min(-(-2 * sms // tiles), steps // MIN_SPLIT_STEPS))
    per = max(1, -(-steps // splits))
    splits = max(1, -(-steps // per))
    return shape, tiles, splits, per * BK


def _check_operands(a, b, out, beta):
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be a matrix, got shape "
                             f"{tuple(t.shape)}")
        if max(t.shape) > _INT32_MAX:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the kernel "
                             "indexes rows and columns with int32")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if out is None and beta != 0.0:
        raise ValueError("beta != 0 needs out=")
    if out is not None:
        shape = (a.shape[0], b.shape[1])
        if (not isinstance(out, torch.Tensor) or out.dtype != torch.float32
                or out.device != a.device or tuple(out.shape) != shape):
            raise ValueError(f"out must be a {shape} float32 tensor on "
                             f"{a.device}")


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, out=None,
                  alpha: float = 1.0, beta: float = 0.0):
    """alpha * a @ b + beta * out in 3xTF32, fp32. a (m, k) and b (k, n)
    each with contiguous rows or contiguous columns (a transpose view is
    read as it lies); out, when given, an (m, n) fp32 tensor with
    contiguous rows, written in place and returned (beta = 0 never reads
    it). CPU tensors run the plain twin; CUDA tensors launch a kernel,
    once, on the current stream, on the route `launch_plan` picks, or
    raise."""
    return _matmul_on_route(a, b, out, alpha, beta, None)


def _matmul_on_route(a, b, out, alpha, beta, route):
    """`matmul_3xtf32` with the route forced to 'wgmma' or 'mma' (None:
    `launch_plan`'s); raises for CUDA operands that the forced route does
    not take. For `chip_smoke.py`, which checks and times both routes at
    one shape."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES} or None, got "
                         f"{route!r}")
    _check_operands(a, b, out, beta)
    m, k = a.shape
    n = b.shape[1]
    if out is not None:
        output_stride(out, m, n)
    if a.device.type == "cpu":
        return matmul_3xtf32_plain(a, b, out, alpha, beta)
    if a.device.type != "cuda":
        raise ValueError(f"a is on {a.device}; need cpu or cuda")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ldc = output_stride(out, m, n)
    if m == 0 or n == 0:
        return out
    trans_a, lda, vec_a = operand_layout(a, m, k)
    trans_b, ldb, vec_b = operand_layout(b, k, n)
    tma_a = tma_stride(trans_a, lda, vec_a, m, k)
    tma_b = tma_stride(trans_b, ldb, vec_b, k, n)
    tma = tma_a is not None and tma_b is not None and route != "mma"
    from nngp_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        shape, tiles, splits, k_split = launch_plan(m, n, k, sms, tma)
        taken = ROUTE_OF[shape]
        if route is not None and taken != route:
            raise ValueError(f"route {route!r} does not take a ({m} x {k}) "
                             f"@ ({k} x {n}) product with these layouts")
        work = counters = None
        if splits > 1:
            work = torch.empty(splits * m * n, dtype=torch.float32,
                               device=a.device)
            counters = torch.zeros(tiles, dtype=torch.int32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if taken == "wgmma":
            # a persistent grid: at most one block a SM walks the work
            # items (tile, split)
            err = lib.gemm_3xtf32_wgmma(
                int(trans_a), int(trans_b), int(shape == "wgmma_n64"), m, n,
                k, float(alpha), a.data_ptr(), tma_a, b.data_ptr(), tma_b,
                float(beta), out.data_ptr(), ldc, tiles, splits, k_split,
                min(tiles * splits, sms), gram_cuda._ptr(work),
                gram_cuda._ptr(counters), stream)
        else:
            err = lib.gemm_3xtf32(
                int(trans_a), int(trans_b), int(shape == "narrow"), m, n, k,
                float(alpha), a.data_ptr(), lda, int(vec_a), b.data_ptr(),
                ldb, int(vec_b), float(beta), out.data_ptr(), ldc, tiles,
                splits, k_split, gram_cuda._ptr(work),
                gram_cuda._ptr(counters), stream)
    gram_cuda._raise_on(err, f"gemm_3xtf32 ({taken})")
    gram_cuda._count("gemm", LAUNCHES)
    gram_cuda._count(f"gemm_{taken}", LAUNCHES)
    return out


# -------------------------------------------------------------- dispatch
def kernel_route(precision: str, dtype) -> bool:
    """Whether `mm` runs a product in 3xTF32: precision 'high' on fp32.
    fp64 products stay fp64 under 'high', as JAX's matmul precision leaves
    f64 dots alone."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'highest' or 'high', got "
                         f"{precision!r}")
    return precision == "high" and dtype == torch.float32


def mm(a: torch.Tensor, b: torch.Tensor, precision: str = "highest",
       out=None, alpha: float = 1.0, beta: float = 0.0):
    """alpha * a @ b + beta * out at the Nystrom tier's matmul precision:
    'highest' is `a @ b` (full IEEE, TF32 off), 'high' on fp32 is
    `matmul_3xtf32`. out, when given, is written in place and returned."""
    if kernel_route(precision, a.dtype):
        return matmul_3xtf32(a, b, out=out, alpha=alpha, beta=beta)
    prod = a @ b
    if out is None and alpha == 1.0 and beta == 0.0:
        return prod
    return _epilogue(prod, out, alpha, beta)
