"""The 3xTF32 tensor-core GEMMs (`csrc/gemm_3xtf32.cu`) and `mm`, the one
dispatch of the Nystrom tier's products.

    C = alpha * a @ b + beta * C        (fp32)

`precision='high'` in `gp/nystrom.py` is the counterpart of the JAX
package's `jax.default_matmul_precision('high')`: on the TPU a dot at
Precision.HIGH is bf16_3x (each fp32 operand split into a high and a low
bf16 part, the three large cross products summed); here the parts are
TF32, the same construction on the card:

    big = rna_tf32(x),  small = rna_tf32(x - big)
    a b ~= small_a big_b + big_a small_b + big_a big_b    (fp32 sums)

with ~3 * 2^-22 of |a b| per product, against bf16_3x's ~2^-16. The TF32
lives in the kernels' instructions: `torch.backends.cuda.matmul.allow_tf32`
stays False, as `utils/device.py` sets it.

`matmul_3xtf32` launches one of the file's two kernels for CUDA tensors (or
raises: there is no fallback to cuBLAS) and runs its plain twin
`matmul_3xtf32_plain` for CPU tensors. The route is decided from the
output's width before the launch (`launch_plan`): 'wgmma' (TMA, a producer
warp, wgmma) for outputs wider than NARROW_MAX_N columns, 'narrow' (TMA, a
producer warp, the CUDA cores, K split within a thread block cluster) for
the rest. Both read their streamed operands through TMA, which needs a
16-byte aligned base and a row stride that is a multiple of 16 bytes
(`tma_stride`): an operand that has neither is copied once into a padded
buffer (`padded_copy`) before the launch, and the Nystrom tier lays out the
buffers it owns so from the start (`padded_empty`). A launch error raises.
The twin splits the operands with `tf32_split`, a bit-exact emulation of
`cvt.rna.tf32.f32` on the int32 view, and sums the three products of fp32
`torch.matmul` (whose products of TF32 parts are exact), small terms
first. It does not reproduce the kernels' summation order.

`LAUNCHES` counts kernel launches, as `ops.gram_cuda.LAUNCHES` does for
the Gram kernels: every launch under the key 'gemm', and under
'gemm_wgmma' or 'gemm_narrow' by its route. A launch made while a CUDA
graph is built counts into the graph's own tally
(`ops._build.counting_into`), and `REPLAYS` counts the launches that
replays of such graphs ran (`serve/graphs.py`).

The launch logic is plain Python, tested on the CPU: `operand_layout` reads
an operand's layout (row-major or transposed), row stride and whether its
base and stride allow 16-byte accesses; `tma_stride` whether TMA can
address it, and with which row stride; `output_stride` checks the output;
`launch_plan` picks the route and tile shape, splits K when the output has
too few tiles to fill the SMs, and sizes the grid to one wave.
"""

from typing import NamedTuple

import torch

from nngp_tpu_torch.ops._build import count, load_library, ptr, raise_on

ROUTES = ("wgmma", "narrow")
LAUNCHES = {"gemm": 0, "gemm_wgmma": 0, "gemm_narrow": 0}
# kernel runs by replays of captured CUDA graphs (serve/graphs.py)
REPLAYS = dict.fromkeys(LAUNCHES, 0)

BK = 32                       # the kernels' K-step
# tile shape -> (rows, columns) of its block tile, and its route: the
# wgmma kernel's 128 x 128 and 128 x 64 tiles, the narrow kernel's up to
# 128 rows (NARROW_ROWS) of at most 16 columns
TILES = {"wgmma": (128, 128), "wgmma_n64": (128, 64), "narrow": (128, 16)}
ROUTE_OF = {"wgmma": "wgmma", "wgmma_n64": "wgmma", "narrow": "narrow"}
NARROW_MAX_N = 16             # outputs this narrow take the narrow kernel
N64_MAX_N = 64                # wgmma outputs this narrow take 128 x 64
MIN_SPLIT_STEPS = 8           # K-steps a wgmma split runs at least
NARROW_ROWS = (128, 64, 32)   # the narrow kernel's block rows R; a stage
NARROW_THREADS = 256          # holds 256 / R K-steps, one a consumer thread
NARROW_MIN_STAGES = 4         # stages a narrow K split runs at least
NARROW_CLUSTERS = (8, 4, 2, 1)  # its cluster sizes (K splits), largest first
NARROW_NB = (1, 4, 16)        # its B widths: n padded to one of these
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


def tma_cols(cols: int) -> int:
    """The row stride, in fp32 elements, that TMA can address for rows of
    `cols` elements: cols rounded up to a multiple of 4 (16 bytes)."""
    return -(-cols // 4) * 4


def padded_empty(rows: int, cols: int, dtype=torch.float32, device=None):
    """An uninitialised (rows, cols) tensor whose rows lie tma_cols(cols)
    elements apart: the [:, :cols] view of a (rows, tma_cols(cols)) buffer
    (a plain contiguous tensor when cols is a multiple of 4). The Nystrom
    tier's 'high' products write into such buffers, so that TMA reads them
    as they lie, on the card and on the CPU alike."""
    return torch.empty((rows, tma_cols(cols)), dtype=dtype,
                       device=device)[:, :cols]


def padded_copy(t: torch.Tensor) -> torch.Tensor:
    """t itself when its rows are contiguous, 16 bytes apart in a multiple
    and 16-byte aligned (or it has one row); else a copy into
    `padded_empty` with the same values."""
    rows, cols = t.shape
    if (t.stride(1) == 1 or cols == 1) and t.data_ptr() % 16 == 0 and (
            rows == 1 or (t.stride(0) % 4 == 0 and t.stride(0) >= cols)):
        return t
    out = padded_empty(rows, cols, t.dtype, t.device)
    out.copy_(t)
    return out


class Plan(NamedTuple):
    """One launch: its tile shape (`ROUTE_OF[shape]` is its kernel), the
    output tiles (the narrow kernel's: row blocks), the K splits (the
    narrow kernel's cluster size), the K range of a split, the grid's
    blocks, and the rows of a block tile (the narrow kernel's R)."""
    shape: str
    tiles: int
    splits: int
    k_split: int
    blocks: int
    bm: int = 128


def narrow_stage_k(bm: int) -> int:
    """K of one stage of the narrow kernel with `bm` rows a block."""
    return BK * NARROW_THREADS // bm


def narrow_nb(n: int) -> int:
    """The narrow kernel's B width for an output n <= NARROW_MAX_N columns
    wide: the first of NARROW_NB that holds n."""
    return next(nb for nb in NARROW_NB if n <= nb)


def launch_plan(m: int, n: int, k: int, sms: int, resident=None) -> Plan:
    """The launch of one (m x k) @ (k x n) product.

    Outputs wider than NARROW_MAX_N columns take the wgmma kernel ('wgmma',
    128 x 128 tiles; 'wgmma_n64' up to N64_MAX_N columns): when the tiles
    are fewer than the SMs, K is split so that about two work items a SM
    run, each split at least MIN_SPLIT_STEPS K-steps long, and a persistent
    grid of at most one block a SM walks them.

    Narrower outputs take the narrow kernel: a block owns R output rows
    (one of NARROW_ROWS) and a K range; the K splits of one row block form
    a thread block cluster of S blocks (one of NARROW_CLUSTERS), each
    split at least NARROW_MIN_STAGES stages long. The grid is min(row
    blocks, resident(R, S)) clusters, `resident` being the occupancy API's
    count of such clusters on the card (sms // S when None): one wave.
    Split clusters take one row block each (their blocks meet at a cluster
    barrier after it); single blocks walk the row blocks from their index
    when they are more than the card holds. (R, S) is the pair whose
    busiest block reads the fewest elements of A, then the one with fewer
    splits, then the larger R."""
    if n <= NARROW_MAX_N:
        held = resident or (lambda bm, s: sms // s)
        best = None
        for bm in NARROW_ROWS:
            rows = -(-m // bm)
            step = narrow_stage_k(bm)
            stages = -(-k // step)
            for s in NARROW_CLUSTERS:
                if s > 1 and (stages < s * NARROW_MIN_STAGES
                              or rows > held(bm, s)):
                    continue
                clusters = max(1, min(rows, held(bm, s)))
                per = max(1, -(-stages // s))
                work = -(-rows // clusters) * bm * per * step
                key = (work, s, -bm)
                if best is None or key < best[0]:
                    best = (key, Plan("narrow", rows, s, per * step,
                                      clusters * s, bm))
        return best[1]
    shape = "wgmma_n64" if n <= N64_MAX_N else "wgmma"
    bm, bn = TILES[shape]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // BK)
    splits = 1
    if tiles < sms and steps > 0:
        splits = max(1, min(-(-2 * sms // tiles), steps // MIN_SPLIT_STEPS))
    per = max(1, -(-steps // splits))
    splits = max(1, -(-steps // per))
    return Plan(shape, tiles, splits, per * BK, min(tiles * splits, sms))


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


def _tma_operand(t: torch.Tensor, rows: int, cols: int):
    """(operand, transposed, row stride) of a logical (rows, cols) operand
    for TMA: t as it lies when TMA can address it, else a padded copy of
    its stored matrix (`padded_copy`: at most rows x cols x 8 bytes moved)."""
    trans, ld, vec = operand_layout(t, rows, cols)
    stride = tma_stride(trans, ld, vec, rows, cols)
    if stride is None:
        stored = padded_copy(t.mT if trans else t)
        t = stored.mT if trans else stored
        trans, ld, vec = operand_layout(t, rows, cols)
        stride = tma_stride(trans, ld, vec, rows, cols)
    return t, trans, stride


_RESIDENT = {}


def _resident(lib, trans_a: bool, nb: int):
    """resident(R, S) for `launch_plan`: the narrow kernel's clusters of S
    blocks of R rows that the card holds at once (read by the library's
    setup from the occupancy API), for this layout and B width."""
    def held(bm, splits):
        key = (id(lib), bool(trans_a), nb, bm, splits)
        if key not in _RESIDENT:
            _RESIDENT[key] = int(lib.gemm_3xtf32_narrow_clusters(
                int(trans_a), nb, bm, splits))
        return _RESIDENT[key]
    return held


def _matmul_on_route(a, b, out, alpha, beta, route):
    """`matmul_3xtf32` with the route checked: 'wgmma' or 'narrow' raises
    for CUDA operands that `launch_plan` gives the other kernel (None:
    `launch_plan`'s). For `chip_smoke.py` and `cli/gemm_bench.py`, which
    name the kernel they check and time."""
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
    taken = "narrow" if n <= NARROW_MAX_N else "wgmma"
    if route is not None and taken != route:
        raise ValueError(f"route {route!r} does not take a ({m} x {k}) @ "
                         f"({k} x {n}) product")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ldc = output_stride(out, m, n)
    if m == 0 or n == 0:
        return out
    lib = load_library()
    a, trans_a, lda = _tma_operand(a, m, k)
    if taken == "wgmma":
        b, trans_b, ldb = _tma_operand(b, k, n)
    else:                      # B is read element by element
        trans_b, ldb, _ = operand_layout(b, k, n)
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if taken == "narrow":
            nb = narrow_nb(n)
            plan = launch_plan(m, n, k, sms, _resident(lib, trans_a, nb))
            err = lib.gemm_3xtf32_narrow(
                int(trans_a), int(trans_b), nb, plan.bm, m, n, k,
                float(alpha), a.data_ptr(), lda, b.data_ptr(), ldb,
                float(beta), out.data_ptr(), ldc, plan.tiles, plan.splits,
                plan.k_split, plan.blocks // plan.splits, stream)
        else:
            plan = launch_plan(m, n, k, sms)
            work = counters = None
            if plan.splits > 1:
                work = torch.empty(plan.splits * m * n, dtype=torch.float32,
                                   device=a.device)
                counters = torch.zeros(plan.tiles, dtype=torch.int32,
                                       device=a.device)
            err = lib.gemm_3xtf32_wgmma(
                int(trans_a), int(trans_b), int(plan.shape == "wgmma_n64"),
                m, n, k, float(alpha), a.data_ptr(), lda, b.data_ptr(), ldb,
                float(beta), out.data_ptr(), ldc, plan.tiles, plan.splits,
                plan.k_split, plan.blocks, ptr(work), ptr(counters),
                stream)
    raise_on(err, f"gemm_3xtf32 ({taken})")
    count("gemm", LAUNCHES)
    count(f"gemm_{taken}", LAUNCHES)
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
