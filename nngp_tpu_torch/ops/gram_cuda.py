"""NNGP/NTK Gram matrices through the hand-written CUDA kernels.

Counterpart of `nngp_tpu/ops/gram_pallas.py`. Two kernels in
`csrc/gram.cu` replace its two Pallas kernels:

  gram_sym    -> `_sym_kernel`: the train Gram over the lower tiles only,
                 written with its mirror (a full, exactly symmetric matrix)
                 and with the exact O(n) diagonal recursion plus the fused
                 ridge `diag_add` in place of the computed diagonal;
  gram_cross  -> `_cross_kernel`: the cross Gram K_*t.

Each wrapper has a plain PyTorch twin (`gram_sym_plain`, `gram_cross_plain`)
built from `models.kernel_spec` and `ops.gram`. A CPU tensor goes to the
twin; a CUDA tensor launches the kernel or raises. There is no fallback.
`LAUNCHES` counts kernel launches, so a run can show that it went through
the kernels.

The kernels run a persistent grid: about one block per SM slot walks the
output tiles (`TILE_SHAPE`) in a fixed order. Its launch logic stays in
plain Python here so the CPU tests hold it: `tile_counts`, `tile_of` and
`tile_walk` are the kernel's walk, `lower_tile_coords` its closed form,
and `diag_trajectories` computes the per-row diagonal covariances that the
kernels read instead of running the diagonal recursion per element.
`launch_sym` / `launch_cross` launch into preallocated outputs.

`get` follows `KernelSpec.kernel_fn`: 'nngp', 'ntk' or a tuple of them;
asking for 'ntk' computes both Grams in one pass. `diag_add` lands on the
solve kernel's diagonal: nngp for get='nngp', ntk when ntk is asked for.
`diag` is the exact (nngp, ntk) diagonal pair,
`diag_eval(spec.layers, x, ("nngp", "ntk"))`; a caller that already holds
it (the fit takes its ridge from it) passes it in, otherwise it is computed.
"""

import ctypes
import functools

import numpy as np
import torch

from nngp_tpu_torch.models.kernel_spec import (Dense, KernelSpec,
                                               apply_diag_recursion,
                                               apply_recursion, kernel_eval)
from nngp_tpu_torch.ops.dual_activations import DUALS
from nngp_tpu_torch.ops.gram import input_diag, input_gram

LAUNCHES = {"sym": 0, "cross": 0}

# Output tile (rows, columns) of both kernels per dtype: the fp64 tile is
# half as wide, so its staging fits the same shared memory.
TILE_SHAPE = {torch.float32: (128, 128), torch.float64: (128, 64)}
MAX_LAYERS = 32   # layer-program capacity of the kernels (gram.cu kMaxLayers)
_KINDS = {"relu": 1, "erf": 2, "sin": 3, "abs": 4}  # 0 = Dense
_INT32_MAX = 2 ** 31 - 1


def lower_tile_coords(t: int):
    """(ti, tj) of lower tile t in the row-major order (0,0), (1,0), (1,1),
    (2,0), ... — a Python twin of the kernel's `lower_tile_row`: float32
    sqrt, then integer correction."""
    f = np.float32(t)
    s = np.sqrt(np.float32(8.0) * f + np.float32(1.0))
    ti = int((s - np.float32(1.0)) * np.float32(0.5))
    while ti * (ti + 1) // 2 > t:
        ti -= 1
    while (ti + 1) * (ti + 2) // 2 <= t:
        ti += 1
    return ti, t - ti * (ti + 1) // 2


# ------------------------------------------------- the persistent tile walk
def tile_counts(kind: str, m: int, n: int, dtype):
    """(tiles walked, tile columns) of one launch on an (m, n) output.
    sym (m == n) walks the tiles that meet the lower triangle: q = rows /
    columns of a tile, and tile row ti holds q (ti + 1) of them, the last
    tile row's surplus past the tile columns skipped; cross walks all."""
    bm, bn = TILE_SHAPE[dtype]
    rows, cols = -(-m // bm), -(-n // bn)
    if kind == "sym":
        return (bm // bn) * rows * (rows + 1) // 2, cols
    return rows * cols, cols


def tile_of(kind: str, t: int, cols: int, q: int):
    """(ti, tj) of walk step t, or None for a skipped step: the kernel's
    closed form, tile row ti = lower_tile_coords(t // q)'s row."""
    if kind == "sym":
        ti, _ = lower_tile_coords(t // q)
        tj = t - q * ti * (ti + 1) // 2
        return (ti, tj) if tj < cols else None
    return divmod(t, cols)


def tile_walk(kind: str, m: int, n: int, dtype, grid: int):
    """The tiles that each block of a persistent grid of `grid` blocks
    visits, in order: block b takes steps b, b + grid, ... (the grid is
    capped at the step count, as the launch caps it)."""
    tiles, cols = tile_counts(kind, m, n, dtype)
    bm, bn = TILE_SHAPE[dtype]
    grid = min(grid, tiles)
    walk = []
    for b in range(grid):
        seq = (tile_of(kind, t, cols, bm // bn) for t in range(b, tiles, grid))
        walk.append([tile for tile in seq if tile is not None])
    return walk


def diag_trajectories(layers, d: torch.Tensor) -> torch.Tensor:
    """(A, n): the diagonal covariance entering each of the spec's A
    activation layers, from the input diagonal d (n,). These are the d1 /
    d2 of `apply_recursion`, by the same operations in the same order, so
    the kernels' per-element recursion reads the twin's values."""
    out = []
    for layer in layers:
        if isinstance(layer, Dense):
            d = layer.w_std ** 2 * d + layer.b_std ** 2
        else:
            out.append(d)
            d = DUALS[layer.name][2](d)
    if not out:
        return d.new_zeros((0, d.shape[0]))
    return out[0][None] if len(out) == 1 else torch.stack(out)


def _want_ntk(get) -> bool:
    gets = get if isinstance(get, (tuple, list)) else (get,)
    for g in gets:
        if g not in ("nngp", "ntk"):
            raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    return "ntk" in gets


def _check_input(x, name):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {x.device}; need cpu or cuda")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} must be float32 or float64, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} must be a non-empty (rows, features) "
                         f"matrix, got shape {tuple(x.shape)}")
    if x.shape[0] > _INT32_MAX or x.shape[1] > _INT32_MAX:
        raise ValueError(f"{name} has shape {tuple(x.shape)}; kernels index "
                         "rows and features with int32")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _exact_diags(spec, dx, want_ntk, diag_add, diag):
    """(nngp diagonal, ntk diagonal or None): the given exact pair `diag`,
    or the O(n) recursion from the input diagonal dx, with the ridge on the
    solve kernel's diagonal."""
    if diag is None:
        dn, dt = apply_diag_recursion(dx, spec.layers)
    else:
        dn, dt = diag
        if any(v.shape != dx.shape or v.device != dx.device for v in diag):
            raise ValueError(f"diag must be two {tuple(dx.shape)} tensors on "
                             f"{dx.device}")
    add = 0.0 if diag_add is None else diag_add
    if want_ntk:
        return dn, dt + add
    return dn + add, None


def _mirror_lower(k):
    """The strict lower triangle mirrored into the upper one."""
    return torch.tril(k) + torch.tril(k, -1).mT


# ------------------------------------------------------------ plain twins
def gram_sym_plain(spec: KernelSpec, x: torch.Tensor, get="nngp",
                   diag_add=None, diag=None):
    """Plain PyTorch version of `gram_sym`: same contract, same output."""
    want_ntk = _want_ntk(get)
    dx = input_diag(x)
    k0 = input_gram(x, x)
    nngp, ntk = apply_recursion(k0, torch.zeros_like(k0), dx[:, None],
                                dx[None, :], spec.layers)
    diag0, diag1 = _exact_diags(spec, dx, want_ntk, diag_add, diag)
    nngp = _mirror_lower(nngp)
    nngp.diagonal().copy_(diag0)
    if want_ntk:
        ntk = _mirror_lower(ntk)
        ntk.diagonal().copy_(diag1)
    return KernelSpec._select(nngp, ntk, get)


def gram_cross_plain(spec: KernelSpec, x1: torch.Tensor, x2: torch.Tensor,
                     get="nngp"):
    """Plain PyTorch version of `gram_cross`."""
    _want_ntk(get)
    return kernel_eval(spec.layers, x1, x2, get)


# ---------------------------------------------------------------- kernels
def _program(spec):
    """The layer program as ctypes arrays (kinds, w^2, b^2) and its length;
    cached per layer tuple (the arrays are only read)."""
    return _program_of(spec.layers)


@functools.lru_cache(maxsize=64)
def _program_of(layers):
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"spec has {len(layers)} layers; the CUDA kernels "
                         f"take at most {MAX_LAYERS}")
    n = len(layers)
    kinds = (ctypes.c_int * n)()
    w2 = (ctypes.c_double * n)()
    b2 = (ctypes.c_double * n)()
    for i, layer in enumerate(layers):
        if isinstance(layer, Dense):
            kinds[i] = 0
            w2[i] = layer.w_std ** 2
            b2[i] = layer.b_std ** 2
        else:
            kinds[i] = _KINDS[layer.name]
    return kinds, w2, b2, n


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_out(out, n_rows, n_cols, like, name):
    if (not isinstance(out, torch.Tensor) or out.shape != (n_rows, n_cols)
            or out.dtype != like.dtype or out.device != like.device
            or not out.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({n_rows}, {n_cols}) "
                         f"{like.dtype} tensor on {like.device}")


def gram_sym(spec: KernelSpec, x: torch.Tensor, get="nngp", diag_add=None,
             diag=None):
    """Symmetric Gram kernel(x, x): exactly symmetric, with the exact
    diagonal (+ `diag_add` on the solve kernel). Same contract as
    `gram_pallas(spec, x, get=get, mirror='full', diag_add=diag_add)`."""
    _check_input(x, "x")
    want_ntk = _want_ntk(get)
    if x.device.type == "cpu":
        return gram_sym_plain(spec, x, get, diag_add, diag)
    n = x.shape[0]
    out0 = torch.empty((n, n), dtype=x.dtype, device=x.device)
    out1 = torch.empty_like(out0) if want_ntk else None
    launch_sym(spec, x, out0, out1, diag_add, diag)
    return KernelSpec._select(out0, out1, get)


def launch_sym(spec: KernelSpec, x: torch.Tensor, out0: torch.Tensor,
               out1=None, diag_add=None, diag=None, max_blocks: int = 0):
    """One launch of the symmetric kernel into preallocated (n, n) outputs:
    nngp into `out0` and, when `out1` is given, ntk into it (the ridge then
    lands on ntk). `max_blocks` caps the persistent grid (0: as many
    blocks as fit on the SMs). `gram_sym` calls it; a check can hand it
    outputs filled with NaN to see that every element is written."""
    _check_input(x, "x")
    n, d = x.shape
    want_ntk = out1 is not None
    _check_out(out0, n, n, x, "out0")
    if want_ntk:
        _check_out(out1, n, n, x, "out1")
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}; the kernel needs a CUDA tensor")
    from nngp_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        dx = input_diag(x)
        diag0, diag1 = _exact_diags(spec, dx, want_ntk, diag_add, diag)
        diag0 = diag0.to(x.dtype).contiguous()
        if want_ntk:
            diag1 = diag1.to(x.dtype).contiguous()
        traj = diag_trajectories(spec.layers, dx).contiguous()
        kinds, w2, b2, n_layers = _program(spec)
        fn = lib.gram_sym_f32 if x.dtype == torch.float32 else lib.gram_sym_f64
        err = fn(x.data_ptr(), n, d, d, traj.data_ptr(), traj.shape[0],
                 diag0.data_ptr(), _ptr(diag1), out0.data_ptr(), _ptr(out1), n,
                 ctypes.addressof(kinds), ctypes.addressof(w2),
                 ctypes.addressof(b2), n_layers, int(want_ntk), int(max_blocks),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gram_sym")
    LAUNCHES["sym"] += 1


def gram_cross(spec: KernelSpec, x1: torch.Tensor, x2: torch.Tensor,
               get="nngp"):
    """Cross Gram kernel(x1, x2), shape (m, n). Same contract as
    `spec.kernel_fn(x1, x2, get)`."""
    _check_pair(x1, x2)
    want_ntk = _want_ntk(get)
    if x1.device.type == "cpu":
        return gram_cross_plain(spec, x1, x2, get)
    out0 = torch.empty((x1.shape[0], x2.shape[0]), dtype=x1.dtype,
                       device=x1.device)
    out1 = torch.empty_like(out0) if want_ntk else None
    launch_cross(spec, x1, x2, out0, out1)
    return KernelSpec._select(out0, out1, get)


def _check_pair(x1, x2):
    _check_input(x1, "x1")
    _check_input(x2, "x2")
    if x1.device != x2.device or x1.dtype != x2.dtype:
        raise ValueError(f"x1 ({x1.device}, {x1.dtype}) and x2 ({x2.device}, "
                         f"{x2.dtype}) must share device and dtype")
    if x1.shape[1] != x2.shape[1]:
        raise ValueError(f"feature dims differ: {x1.shape[1]} vs {x2.shape[1]}")


def launch_cross(spec: KernelSpec, x1: torch.Tensor, x2: torch.Tensor,
                 out0: torch.Tensor, out1=None, max_blocks: int = 0):
    """One launch of the cross kernel into preallocated (m, n) outputs
    (ntk into `out1` when given); `max_blocks` as in `launch_sym`."""
    _check_pair(x1, x2)
    m, d = x1.shape
    n = x2.shape[0]
    want_ntk = out1 is not None
    _check_out(out0, m, n, x1, "out0")
    if want_ntk:
        _check_out(out1, m, n, x1, "out1")
    if x1.device.type != "cuda":
        raise ValueError(f"x1 is on {x1.device}; the kernel needs a CUDA "
                         "tensor")
    from nngp_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(x1.device):
        traj1 = diag_trajectories(spec.layers, input_diag(x1)).contiguous()
        traj2 = diag_trajectories(spec.layers, input_diag(x2)).contiguous()
        kinds, w2, b2, n_layers = _program(spec)
        fn = (lib.gram_cross_f32 if x1.dtype == torch.float32
              else lib.gram_cross_f64)
        err = fn(x1.data_ptr(), m, d, x2.data_ptr(), n, d, d,
                 traj1.data_ptr(), traj2.data_ptr(), traj1.shape[0],
                 out0.data_ptr(), _ptr(out1), n,
                 ctypes.addressof(kinds), ctypes.addressof(w2),
                 ctypes.addressof(b2), n_layers, int(want_ntk), int(max_blocks),
                 torch.cuda.current_stream(x1.device).cuda_stream)
    _raise_on(err, "gram_cross")
    LAUNCHES["cross"] += 1
