"""The Gram wrappers of `nngp_tpu_torch.ops.gram_cuda` on the CPU, where
they run their plain PyTorch twins, against the JAX package; the Python
twin of the CUDA kernels' persistent tile walk and lower-tile index
formula; the diagonal trajectories the kernels read; the wrappers' input
checks; and the kernel build's failure paths.

The CUDA kernels themselves run only on a GPU: `python3 chip_smoke.py`
holds them against these same twins on the card.

Tolerances: fp32 against the Pallas kernel (interpret mode) is the bound
of tests/test_gram_pallas.py (rtol 2e-5, atol 1e-3: two fp32 contractions
in different orders, and the Pallas kernel's polynomial acos); fp64
against `kernel_eval` is rtol 1e-10 for nngp and 1e-7 for ntk (see
tests/test_torch_kernel_spec.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nngp_tpu.models import kernel_spec as jk
from nngp_tpu.ops.gram_pallas import gram_pallas
from nngp_tpu_torch.models.kernel_spec import (KernelSpec,
                                               apply_diag_recursion, mlp,
                                               reference_kernel)
from nngp_tpu_torch.ops import _build, gram_cuda
from nngp_tpu_torch.ops.gram import input_diag
from nngp_tpu_torch.ops.gram_cuda import (TILE_SHAPE, diag_trajectories,
                                          gram_cross, gram_cross_plain,
                                          gram_sym, gram_sym_plain,
                                          launch_cross, launch_sym,
                                          lower_tile_coords, tile_counts,
                                          tile_of, tile_walk)
from tests.test_torch_common import jax_spec, n, rows, t

SPECS32 = [reference_kernel(), KernelSpec(mlp(2, activation="erf")),
           KernelSpec(mlp(2, activation="abs", b_std=0.1))]


@pytest.mark.parametrize("spec", SPECS32, ids=["relu", "erf2", "abs2_b"])
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_plain_twins_match_pallas_fp32(spec, get):
    x = rows(40, seed=0, dtype=np.float32, special=False)
    x1 = rows(24, seed=1, dtype=np.float32, special=False)
    js = jax_spec(spec)
    want_sym = np.asarray(gram_pallas(js, jnp.asarray(x), get=get,
                                      tile_m=16, tile_n=16, interpret=True))
    got_sym = n(gram_sym(spec, t(x), get))
    np.testing.assert_allclose(got_sym, want_sym, rtol=2e-5, atol=1e-3)
    np.testing.assert_array_equal(got_sym, got_sym.T)
    want_cross = np.asarray(gram_pallas(
        js, jnp.asarray(x1), jnp.asarray(x), get=get, symmetric=False,
        tile_m=8, tile_n=16, interpret=True))
    np.testing.assert_allclose(n(gram_cross(spec, t(x1), t(x), get)),
                               want_cross, rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("act", ["relu", "erf", "sin", "abs"])
@pytest.mark.parametrize("depth,b_std", [(1, 0.0), (3, 0.1)])
def test_plain_twins_match_kernel_eval_fp64(act, depth, b_std):
    spec = KernelSpec(mlp(depth, activation=act, b_std=b_std))
    js = jax_spec(spec)
    x, x1 = rows(37, seed=2), rows(19, seed=3)
    for get, rtol in (("nngp", 1e-10), ("ntk", 1e-7)):
        np.testing.assert_allclose(
            n(gram_sym_plain(spec, t(x), get)),
            np.asarray(jk.self_kernel_eval(js.layers, jnp.asarray(x), get)),
            rtol=rtol)
        np.testing.assert_allclose(
            n(gram_cross_plain(spec, t(x1), t(x), get)),
            np.asarray(js.kernel_fn(jnp.asarray(x1), jnp.asarray(x), get)),
            rtol=rtol)
    # tuple get: both Grams from one pass, same values as the single gets
    k, th = gram_sym(spec, t(x), ("nngp", "ntk"))
    np.testing.assert_array_equal(n(k), n(gram_sym(spec, t(x), "nngp")))
    np.testing.assert_array_equal(n(th), n(gram_sym(spec, t(x), "ntk")))


def test_diag_add_lands_on_the_solve_kernel_diagonal():
    """The exact O(n) diagonal replaces the computed one and the ridge is
    added to the solve kernel only: nngp for get='nngp', Theta when ntk is
    asked for (gram_pallas.py:249-256)."""
    spec = reference_kernel()
    x = t(rows(33, seed=4))
    reg = 0.125
    dn, dt = apply_diag_recursion(input_diag(x), spec.layers)
    k = gram_sym(spec, x, "nngp", diag_add=reg)
    np.testing.assert_array_equal(n(k.diagonal()), n(dn + reg))
    k2, th = gram_sym(spec, x, ("nngp", "ntk"), diag_add=reg)
    np.testing.assert_array_equal(n(k2.diagonal()), n(dn))
    np.testing.assert_array_equal(n(th.diagonal()), n(dt + reg))
    # off the diagonal the ridge changes nothing
    off = ~np.eye(33, dtype=bool)
    np.testing.assert_array_equal(n(k)[off], n(k2)[off])
    # and the JAX kernel agrees on the same semantics (fp32, Pallas with
    # the precise duals: the fast ones NaN on the zero row, see below)
    x32 = rows(33, seed=4, dtype=np.float32)
    jk2, jth = gram_pallas(jax_spec(spec), jnp.asarray(x32),
                           get=("nngp", "ntk"), tile_m=16, tile_n=16,
                           diag_add=reg, interpret=True, fast_math=False)
    pk2, pth = gram_sym(spec, t(x32), ("nngp", "ntk"), diag_add=reg)
    np.testing.assert_allclose(n(pk2), np.asarray(jk2), rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(n(pth), np.asarray(jth), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("get", ["nngp", ("nngp", "ntk")])
def test_given_exact_diagonals_match_the_computed_ones(get):
    """The fit passes the diagonals it took its ridge from; the output is
    the one gram_sym computes without them, bit for bit."""
    spec = KernelSpec(mlp(2, activation="erf", b_std=0.1))
    x = t(rows(21, seed=6))
    diag = apply_diag_recursion(input_diag(x), spec.layers)
    got = gram_sym(spec, x, get, diag_add=0.25, diag=diag)
    want = gram_sym(spec, x, get, diag_add=0.25)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(n(g), n(w))


def test_given_diagonals_of_the_wrong_shape_raise():
    spec = reference_kernel()
    x = t(rows(9, seed=7))
    short = (torch.ones(8, dtype=x.dtype), torch.ones(8, dtype=x.dtype))
    with pytest.raises(ValueError, match="diag must be"):
        gram_sym(spec, x, "nngp", diag=short)


def test_zero_row_is_finite_where_pallas_fast_math_is_not():
    """A zero feature row: the port keeps the 1e-36 floor of the precise
    relu dual (ops/dual_activations.py:50-52), so its Gram row is ~1e-19.
    The Pallas kernel's default fast duals (DUALS_FAST, relu_nngp_f)
    divide by sqrt(k11 k22) unfloored and give NaN there. The JAX package
    is the frozen reference; the port deliberately differs (ROADMAP
    Queue C)."""
    spec = reference_kernel()
    x32 = rows(33, seed=4, dtype=np.float32)
    fast = np.asarray(gram_pallas(jax_spec(spec), jnp.asarray(x32),
                                  tile_m=16, tile_n=16, interpret=True))
    assert np.isnan(fast[1, 0]) and np.isnan(fast[0, 1])
    got = n(gram_sym(spec, t(x32)))
    assert np.all(np.isfinite(got))
    assert 0.0 < got[1, 0] < 1e-17


@pytest.mark.parametrize("nt", range(1, 65))
def test_lower_tile_formula_enumerates_pallas_order(nt):
    """The kernel recovers (ti, tj) from blockIdx.x in closed form; it must
    walk the lower tiles in the row-major order gram_pallas.py:163-165
    builds."""
    ti = np.concatenate([np.full(i + 1, i, np.int32) for i in range(nt)])
    tj = np.concatenate([np.arange(i + 1, dtype=np.int32)
                         for i in range(nt)])
    got = [lower_tile_coords(k) for k in range(nt * (nt + 1) // 2)]
    assert got == list(zip(ti.tolist(), tj.tolist()))


def test_lower_tile_formula_past_float32_precision():
    """Near the int32 grid limit float32's sqrt is off by whole rows; the
    integer correction must still land on the right one."""
    for t_ in (2 ** 31 - 1, 2 ** 31 - 2, 10 ** 9 + 7, 123456789, 2 ** 24 + 1):
        ti, tj = lower_tile_coords(t_)
        assert ti * (ti + 1) // 2 <= t_ < (ti + 1) * (ti + 2) // 2
        assert 0 <= tj <= ti and ti * (ti + 1) // 2 + tj == t_


RAGGED = (1, 63, 64, 65, 127, 128, 129, 1017, 10800)
GRIDS = (1, 7, 132, 264, 10 ** 6)


def _visits(kind, m, n, dtype, grid):
    walk = tile_walk(kind, m, n, dtype, grid)
    assert len(walk) == min(grid, tile_counts(kind, m, n, dtype)[0])
    return [tile for block in walk for tile in block]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", RAGGED)
def test_sym_walk_visits_every_lower_tile_once(n, dtype):
    """For every persistent-grid size the blocks together visit each tile
    that meets the lower triangle (tile rows of TILE_SHAPE[0], columns of
    TILE_SHAPE[1], so fp64's walk takes two tile columns per tile row)
    exactly once, and no other tile."""
    bm, bn = TILE_SHAPE[dtype]
    rows, cols = -(-n // bm), -(-n // bn)
    want = sorted((ti, tj) for ti in range(rows) for tj in range(cols)
                  if tj * bn <= min(n, (ti + 1) * bm) - 1)
    for grid in GRIDS:
        assert sorted(_visits("sym", n, n, dtype, grid)) == want, grid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", RAGGED)
def test_cross_walk_visits_every_tile_once(n, dtype):
    m = max(1, n // 3)
    bm, bn = TILE_SHAPE[dtype]
    want = sorted((ti, tj) for ti in range(-(-m // bm))
                  for tj in range(-(-n // bn)))
    for grid in GRIDS:
        assert sorted(_visits("cross", m, n, dtype, grid)) == want, grid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 65, 129, 300])
def test_sym_walk_covers_each_lower_element_in_one_tile(n, dtype):
    """Each element on or below the diagonal lies in exactly one visited
    tile: the kernel writes it there and its mirror from the same value."""
    bm, bn = TILE_SHAPE[dtype]
    hits = np.zeros((n, n), np.int64)
    for ti, tj in _visits("sym", n, n, dtype, 7):
        hits[ti * bm:(ti + 1) * bm, tj * bn:(tj + 1) * bn] += 1
    lower = np.tril(np.ones((n, n), bool))
    assert np.all(hits[lower] == 1)


def test_walk_step_order_and_skips():
    """Blocks take steps b, b + grid, ...; the fp64 sym walk's last tile row
    may run past the tile columns, and those steps are skipped."""
    assert tile_walk("cross", 200, 300, torch.float32, 2) == [
        [(0, 0), (0, 2), (1, 1)], [(0, 1), (1, 0), (1, 2)]]
    # n = 129 in fp64: 2 tile rows, 3 tile columns; tile row 1 holds 4 steps
    assert tile_counts("sym", 129, 129, torch.float64) == (6, 3)
    assert [tile_of("sym", s, 3, 2) for s in range(6)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (1, 2), None]


def test_no_row_tile_limit():
    """The persistent 1-D walk has no grid dimension to overflow: more than
    65,535 row tiles (the old 2-D grid's limit) are walked like any other."""
    m = 65536 * TILE_SHAPE[torch.float32][0] + 1
    tiles, cols = tile_counts("cross", m, 100, torch.float32)
    assert (tiles, cols) == (65537, 1)
    assert tile_of("cross", tiles - 1, cols, 1) == (65536, 0)
    tiles, _ = tile_counts("sym", m, m, torch.float32)
    assert tile_of("sym", tiles - 1, 65537, 1) == (65536, 65536)


@pytest.mark.parametrize("spec", [
    reference_kernel(), KernelSpec(mlp(3, activation="erf", b_std=0.1)),
    KernelSpec(mlp(2, activation="sin", w_std=1.3, b_std=0.2)),
    KernelSpec(mlp(2, activation="abs")),
], ids=["relu", "erf3_b", "sin2_wb", "abs2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diag_trajectories_are_the_recursions_own(spec, dtype):
    """The kernels read, per row, the diagonal covariance entering each
    activation: exactly the d1 that apply_recursion carries there."""
    from nngp_tpu_torch.models.kernel_spec import apply_recursion
    from nngp_tpu_torch.ops.dual_activations import DUALS

    x = t(rows(29, seed=8, dtype=np.float32 if dtype == torch.float32
               else np.float64))
    dx = input_diag(x)
    seen = []

    def spy(name):
        fn, dot, tdiag = DUALS[name]

        def record(k, d1, d2):
            seen.append(d1.reshape(-1).clone())
            return fn(k, d1, d2)
        return record, dot, tdiag

    duals = {name: spy(name) for name in DUALS}
    k0 = torch.zeros(29, 1, dtype=dtype)
    apply_recursion(k0, torch.zeros_like(k0), dx[:, None], dx[:1, None],
                    spec.layers, duals=duals)
    traj = diag_trajectories(spec.layers, dx)
    assert traj.shape == (len(seen), 29)
    for got, want in zip(traj, seen):
        assert torch.equal(got, want)


def test_launchers_check_outputs_then_device():
    spec = reference_kernel()
    x = torch.ones(5, 3)
    with pytest.raises(ValueError, match="out0 must be"):
        launch_sym(spec, x, torch.empty(5, 4))
    with pytest.raises(ValueError, match="out1 must be"):
        launch_sym(spec, x, torch.empty(5, 5), torch.empty(5, 5).mT[:, :5])
    with pytest.raises(ValueError, match="out0 must be"):
        launch_sym(spec, x, torch.empty(5, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch_sym(spec, x, torch.empty(5, 5), torch.empty(5, 5))
    with pytest.raises(ValueError, match="out0 must be"):
        launch_cross(spec, x[:2], x, torch.empty(5, 2))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch_cross(spec, x[:2], x, torch.empty(2, 5))


def test_ctypes_signatures_match_the_c_entry_points():
    """The argtypes `_build` declares have one entry per parameter of the
    C entry points (gram.cu's SYM_ARGS / CROSS_ARGS)."""
    import re

    with open(_build.SOURCE) as f:
        src = f.read()
    for macro, argtypes in (("SYM_ARGS", _build._SYM_ARGTYPES),
                            ("CROSS_ARGS", _build._CROSS_ARGTYPES)):
        body = re.search(rf"#define {macro}(.*?)\n#define", src, re.S).group(1)
        assert body.count(",") + 1 == len(argtypes), macro


def test_bench_per_element_counts_loop_work():
    """The SASS estimate on a made-up listing: a staging loop of 4
    instructions a cp.async, a dot loop of 2 an FFMA, 6 K0 instructions, a
    recursion loop of 12 over 2 elements (6 MUFU) and a store loop of 3 an
    STG."""
    from nngp_tpu_torch.cli.gram_bench import per_element

    listing = ["LDGSTS", "IADD3", "ISETP", "BRA 0x0",          # 0-3
               "FFMA", "BRA 0x40",                            # 4-5
               "FMUL", "FFMA", "FFMA", "STS", "IADD3", "BAR.SYNC",  # 6-11
               "MUFU.RSQ", "MUFU.RSQ", "MUFU.RSQ", "FADD", "FMUL", "FADD",
               "MUFU.RSQ", "MUFU.RSQ", "MUFU.RSQ", "FADD", "FMUL",
               "BRA 0xc0",                                    # 12-23
               "LDS", "STG", "BRA 0x180", "EXIT"]             # 24-27
    ins = [(f"{16 * i:04x}", x) for i, x in enumerate(listing)]
    got = per_element(ins, sym=False, d=2, own=1, copies=1)
    assert got == {"stage": 4.0, "dot": 4.0, "k0": 6.0, "recursion": 6.0,
                   "store": 3.0, "total": 23.0}
    assert per_element(ins, sym=True, d=2, own=1, copies=1)["store"] == 3.0


def test_bench_needs_a_gpu(capsys):
    from nngp_tpu_torch.cli import gram_bench

    assert gram_bench.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_cpu_tensors_use_the_plain_twins_without_counting_launches():
    spec = reference_kernel()
    x = t(rows(12, seed=5))
    before = dict(gram_cuda.LAUNCHES)
    gram_sym(spec, x, "ntk", diag_add=0.5)
    gram_cross(spec, x[:5], x, ("nngp", "ntk"))
    assert gram_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, 3, dtype=torch.int32), TypeError),
    (torch.zeros(4, 3, dtype=torch.float16), TypeError),
    (torch.zeros(3, 4).mT, ValueError),          # not contiguous
    (torch.zeros(4), ValueError),                # not 2-D
    (torch.zeros(0, 3), ValueError),             # empty
    (np.zeros((4, 3)), TypeError),               # not a tensor
])
def test_wrappers_reject_bad_inputs(bad, err):
    spec = reference_kernel()
    with pytest.raises(err):
        gram_sym(spec, bad)
    with pytest.raises(err):
        gram_cross(spec, bad, torch.ones(4, 3))


def test_cross_rejects_mismatched_operands():
    spec = reference_kernel()
    with pytest.raises(ValueError, match="feature dims"):
        gram_cross(spec, torch.ones(2, 3), torch.ones(4, 5))
    with pytest.raises(ValueError, match="share device and dtype"):
        gram_cross(spec, torch.ones(2, 3), torch.ones(4, 3,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="get must be"):
        gram_cross(spec, torch.ones(2, 3), torch.ones(4, 3), "theta")


def test_build_raises_when_nvcc_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'gram.cu(1): error: no sm_90a' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no sm_90a"):
        _build.build()
    assert not _build.is_built()
    assert list((tmp_path / "build").iterdir()) == []   # no partial output
