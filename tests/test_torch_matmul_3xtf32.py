"""precision='high' in the port: the 3xTF32 GEMM's plain twin and launch
logic (`nngp_tpu_torch.ops.matmul`), and the Nystrom tier's products under
'high' against the JAX package's, on the CPU.

On the CPU `matmul_3xtf32` runs its twin (the kernel, `csrc/gemm_3xtf32.cu`,
is held to the twin on the card by `chip_smoke.py` phase 17). JAX's
`jax.default_matmul_precision('high')` computes full fp32 dots on the CPU,
so the JAX side of each comparison is an fp32 product. Tolerances, and why:

  - `tf32_split` equals a numpy model of `cvt.rna.tf32.f32` (exact
    rounding in fp64 to 11 significant bits, or to multiples of 2^-136
    below the smallest normal, ties away from zero) bit for bit.
  - the twin against an fp64 product: |twin - exact| <= (3 * 2^-22 +
    K * 2^-24) (|A| @ |B|) elementwise: the split's error per product plus
    fp32 accumulation over K terms (the worst-case bound of a K-term fp32
    sum, u = 2^-24).
  - fp32 fits on integer rows: the moments c_raw, b_w and m1_w within rel
    5e-6 (nngp) and 5e-4 (ntk) of the largest entry, the predictions within
    1e-4: port 'highest' and JAX 'highest' differ by 8e-7 / 8e-5 / 3e-5 on
    the same rows (the generic NTK dual's acos at rho = 1 carries sqrt(eps32)
    noise, as tests/test_torch_nystrom.py says), and 'high' moves neither.
  - the forest_2048 pins (m = 256) in fp32: 'high' is held to JAX's fp32
    'high' run with the band that the port's fp32 'highest' holds against
    JAX's fp32 'highest' run (0.5% median, 1% p95).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.nystrom as JN
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.gp import nystrom as TN
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from nngp_tpu_torch.ops import _build, gram_cuda
from nngp_tpu_torch.ops import matmul as MM
from nngp_tpu_torch.serve import Estimator
from nngp_tpu_torch.serve import graphs
from tests.test_nystrom import _skewed_data
from tests.test_socket_server import _mk_lines
from tests.test_torch_common import jax_spec, n
from tests.test_torch_nystrom_serve import (  # noqa: F401
    LINES, _close, _pair, toy)
from tests.torch_parallel_cases import on_ranks

SPEC = reference_kernel()
MOMENT_RTOL = {"nngp": 5e-6, "ntk": 5e-4}
PREDICT_RTOL = 1e-4


# ------------------------------------------------------------ the split
def _rna_tf32_model(x: np.ndarray) -> np.ndarray:
    """numpy model of cvt.rna.tf32.f32 on fp32 x: round |x| to a multiple
    of its TF32 unit (2^(e - 11) for x = f 2^e, 0.5 <= f < 1, and 2^-136
    below the smallest normal), ties away from zero, in exact fp64."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(x64)
    unit = np.ldexp(1.0, np.maximum(e, -125) - 11)
    mag = np.floor(np.abs(x64) / unit + 0.5) * unit
    with np.errstate(over="ignore"):
        out = np.copysign(mag, x64).astype(np.float32)
    return np.where(np.isfinite(x), out, x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _special_floats():
    rng = np.random.default_rng(0)
    # random bit patterns over every exponent, both signs
    pats = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    finite = pats.view(np.float32)
    finite = finite[np.isfinite(finite)]
    # exact ties: the dropped 13 bits are 0x1000, and one ulp to each side
    mant = rng.integers(0, 2 ** 10, 300, dtype=np.uint32) << 13
    expo = rng.integers(1, 254, 300, dtype=np.uint32) << 23
    ties = (expo | mant | 0x1000).astype(np.uint32)
    near = np.concatenate([ties, ties - 1, ties + 1])
    near = np.concatenate([near, near | 0x80000000]).view(np.float32)
    # subnormals (exponent 0), their ties, zero and -0, the extremes
    sub = rng.integers(1, 2 ** 23, 500, dtype=np.uint32)
    sub = np.concatenate([sub, (sub & ~np.uint32(0x1FFF)) | 0x1000])
    sub = np.concatenate([sub, sub | 0x80000000]).view(np.float32)
    edge = np.array([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).max,
                     -np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                     np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([finite, near, sub, edge]).astype(np.float32)


def test_tf32_split_is_the_rounding_mode_bit_for_bit():
    """big = rna_tf32(x) and small = rna_tf32(x - big) equal the numpy
    model bit for bit on random bit patterns, exact ties (0x1000 dropped)
    and their neighbours, subnormals, zero, -0 and the extremes; NaN stays
    NaN; x - big - small is within 2^-22 of |x| where small is normal."""
    x = _special_floats()
    big, small = MM.tf32_split(torch.from_numpy(x))
    big, small = big.numpy(), small.numpy()
    want_big = _rna_tf32_model(x)
    ok = ~np.isnan(x)
    np.testing.assert_array_equal(_bits(big)[ok], _bits(want_big)[ok])
    assert np.all(np.isnan(big[~ok]))
    fin = np.isfinite(x) & np.isfinite(want_big)
    rest = (x[fin] - want_big[fin]).astype(np.float32)
    np.testing.assert_array_equal(_bits(small[fin]),
                                  _bits(_rna_tf32_model(rest)))
    assert np.all(_bits(big) & 0x1FFF == 0) and np.all(
        _bits(small[fin]) & 0x1FFF == 0)
    normal = fin & (np.abs(x) >= 2.0 ** -100) & (np.abs(x) < 1e38)
    err = np.abs(x[normal].astype(np.float64) - big[normal] - small[normal])
    assert np.all(err <= 2.0 ** -22 * np.abs(x[normal].astype(np.float64)))
    with pytest.raises(TypeError, match="float32"):
        MM.tf32_split(torch.zeros(3, dtype=torch.float64))


# ------------------------------------------------------------ the twin
def _operand(rng, rows, cols, trans):
    """A (rows, cols) fp32 operand, as a transpose view when `trans`."""
    if trans:
        return torch.from_numpy(rng.standard_normal((cols, rows)).astype(
            np.float32)).mT
    return torch.from_numpy(rng.standard_normal((rows, cols)).astype(
        np.float32))


@pytest.mark.parametrize("k", [1, 8, 100, 1000])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["NN", "TN", "NT", "TT"])
def test_twin_against_fp64_within_the_3xtf32_bound(k, ta, tb):
    """alpha / beta in {(1, 0), (1, 1), (-1, 1), (0.5, -2)}: |twin -
    exact| <= (3 * 2^-22 + K 2^-24) (|alpha| |A| @ |B| + |beta C|) + one
    rounding of the epilogue, elementwise."""
    rng = np.random.default_rng(k)
    m, nn = 33, 17
    a, b = _operand(rng, m, k, ta), _operand(rng, k, nn, tb)
    a64, b64 = a.double(), b.double()
    scale = a64.abs() @ b64.abs()
    c0 = torch.from_numpy(rng.standard_normal((m, nn)).astype(np.float32))
    u = 2.0 ** -24
    for alpha, beta in ((1.0, 0.0), (1.0, 1.0), (-1.0, 1.0), (0.5, -2.0)):
        out = c0.clone()
        got = MM.matmul_3xtf32(a, b, out=out, alpha=alpha, beta=beta)
        assert got is out
        want = alpha * (a64 @ b64) + beta * c0.double()
        c_abs = c0.double().abs()
        bound = ((3 * 2.0 ** -22 + k * u) * abs(alpha) * scale
                 + 2 * u * (abs(alpha) * scale + abs(beta) * c_abs))
        assert torch.all((got.double() - want).abs() <= bound)
    fresh = MM.matmul_3xtf32(a, b)
    assert fresh.shape == (m, nn) and fresh.is_contiguous()
    assert torch.all((fresh.double() - a64 @ b64).abs()
                     <= (3 * 2.0 ** -22 + k * u) * scale)


def test_twin_beats_the_tf32_and_matches_fp32_grade():
    """At K = 2,048 on N(0, 1) data the twin's largest error relative to
    |A| @ |B| is fp32 grade (within 2x fp32 torch.matmul's, below 1e-7),
    while one TF32 product's is hundreds of times larger (above 1e-5)."""
    rng = np.random.default_rng(5)
    a = _operand(rng, 64, 2048, False)
    b = _operand(rng, 2048, 48, False)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    twin = float(((MM.matmul_3xtf32(a, b).double() - exact).abs()
                  / scale).max())
    (ab, _), (bb, _) = MM.tf32_split(a), MM.tf32_split(b)
    one_pass = float((((ab @ bb).double() - exact).abs() / scale).max())
    fp32 = float((((a @ b).double() - exact).abs() / scale).max())
    assert twin < min(2 * fp32, 1e-7) and one_pass > 1e-5


# ------------------------------------------------------------ launch logic
def test_operand_layout_reads_the_strides():
    base = torch.zeros((12, 8))
    assert MM.operand_layout(base, 12, 8) == (False, 8, True)
    assert MM.operand_layout(base.mT, 8, 12) == (True, 8, True)
    # a row block of a wider matrix keeps its stride; an odd stride or an
    # unaligned base copies 4 bytes at a time
    wide = torch.zeros((12, 10))
    assert MM.operand_layout(wide[:, :7], 12, 7) == (False, 10, False)
    assert MM.operand_layout(base[:, 1:5], 12, 4) == (False, 8, False)
    # one column: either layout; the transposed one (one stored row) copies
    # 16 bytes at a time
    col = torch.zeros((12, 1))
    assert MM.operand_layout(col, 12, 1) == (True, 12, True)
    row = torch.zeros((1, 12))
    assert MM.operand_layout(row, 1, 12) == (False, 12, True)
    with pytest.raises(ValueError, match="neither contiguous"):
        MM.operand_layout(torch.zeros((6, 6))[::2, ::2], 3, 3)


def test_output_stride_and_checks():
    assert MM.output_stride(torch.zeros((4, 6)), 4, 6) == 6
    assert MM.output_stride(torch.zeros((4, 9))[:, :6], 4, 6) == 9
    assert MM.output_stride(torch.zeros((4, 1)), 4, 1) == 1
    assert MM.output_stride(torch.zeros((1, 6)), 1, 6) == 6
    with pytest.raises(ValueError, match="contiguous"):
        MM.output_stride(torch.zeros((6, 4)).mT, 4, 6)
    a, b = torch.zeros((3, 4)), torch.zeros((4, 5))
    for args, kw, err, match in (
            ((a.double(), b), {}, TypeError, "float32"),
            ((a, b[:3]), {}, ValueError, "inner dimensions"),
            ((a[0], b), {}, ValueError, "matrix"),
            ((a, b), {"beta": 1.0}, ValueError, "needs out="),
            ((a, b), {"out": torch.zeros((3, 4))}, ValueError, "out must"),
            ((a, b), {"out": torch.zeros((5, 3)).mT}, ValueError,
             "contiguous"),
            ((a, "b"), {}, TypeError, "torch.Tensor"),
            ((a.to("meta"), b.to("meta")), {}, ValueError, "cpu or cuda")):
        with pytest.raises(err, match=match):
            MM.matmul_3xtf32(*args, **kw)


def test_launch_plan_tiles_and_splits():
    """The panel product fills the card with wgmma tiles and no split, one
    block a SM; an output column takes the narrow kernel and splits K over
    a cluster; every split but the last is a whole number of K-steps (the
    narrow kernel's: of 64-deep stages) and the splits cover K."""
    assert MM.launch_plan(16384, 2048, 2048, 132) == ("wgmma", 2048, 1,
                                                      2048, 132, 128)
    assert MM.launch_plan(65536, 64, 2112, 132) == ("wgmma_n64", 512, 1,
                                                    2112, 132, 128)
    for m, nn, k in ((2048, 1, 16384), (8192, 1, 2048), (2048, 64, 2048),
                     (17, 17, 129), (1, 1, 1), (5, 3, 0), (1000, 16, 1000)):
        shape, tiles, splits, k_split, blocks, bm = MM.launch_plan(m, nn, k,
                                                                   132)
        bn = MM.TILES[shape][1]
        narrow = nn <= MM.NARROW_MAX_N
        assert shape == ("narrow" if narrow else
                         "wgmma_n64" if nn <= MM.N64_MAX_N else "wgmma")
        assert tiles == -(-m // bm) * (1 if narrow else -(-nn // bn))
        step = MM.narrow_stage_k(bm) if narrow else MM.BK
        assert k_split % step == 0 and k_split >= step
        assert (splits - 1) * k_split < max(k, 1) <= splits * k_split
        assert blocks <= 132
        if splits > 1 and not narrow:
            assert tiles < 132 and k_split >= MM.MIN_SPLIT_STEPS * MM.BK
        if splits > 1 and narrow:
            assert k_split >= MM.NARROW_MIN_STAGES * step
    assert MM.launch_plan(2048, 1, 16384, 132).splits > 1


def test_mm_dispatch():
    """'highest' is a @ b bit for bit; 'high' on fp32 is the twin; 'high'
    on fp64 is a @ b bit for bit (JAX leaves f64 dots alone); out=,
    alpha and beta on both routes; another precision raises."""
    rng = np.random.default_rng(2)
    a32 = _operand(rng, 20, 30, False)
    b32 = _operand(rng, 30, 10, True)
    a64, b64 = a32.double(), b32.double()
    assert torch.equal(MM.mm(a32, b32, "highest"), a32 @ b32)
    assert torch.equal(MM.mm(a64, b64, "high"), a64 @ b64)
    assert torch.equal(MM.mm(a32, b32, "high"),
                       MM.matmul_3xtf32_plain(a32, b32))
    c = torch.ones((20, 10), dtype=torch.float64)
    got = MM.mm(a64, b64, "high", out=c, alpha=-1.0, beta=1.0)
    assert got is c and torch.equal(c, 1.0 - a64 @ b64)
    assert MM.kernel_route("high", torch.float32)
    assert not MM.kernel_route("high", torch.float64)
    assert not MM.kernel_route("highest", torch.float32)
    with pytest.raises(ValueError, match="precision"):
        MM.mm(a32, b32, "default")


def test_graph_replays_count_the_gemm():
    """A captured bucket's tally holds every kernel's key, the GEMM's per
    route too: a replay adds 'gemm' and 'gemm_<route>' to matmul.REPLAYS
    and the Gram kernels' to gram_cuda.REPLAYS; a launch made under
    `counting_into` (a capture) counts into its tally, by route, not into
    LAUNCHES."""
    before = (dict(MM.REPLAYS), dict(gram_cuda.REPLAYS), dict(MM.LAUNCHES))
    tally = graphs._tally()
    assert tally == {"sym": 0, "cross": 0, "gemm": 0, "gemm_wgmma": 0,
                     "gemm_narrow": 0}
    assert set(MM.REPLAYS) == set(MM.LAUNCHES) == {
        "gemm", *(f"gemm_{r}" for r in MM.ROUTES)}
    graphs._add_replays({"sym": 0, "cross": 2, "gemm": 5, "gemm_wgmma": 3,
                         "gemm_narrow": 2})
    assert MM.REPLAYS["gemm"] == before[0]["gemm"] + 5
    assert MM.REPLAYS["gemm_wgmma"] == before[0]["gemm_wgmma"] + 3
    assert MM.REPLAYS["gemm_narrow"] == before[0]["gemm_narrow"] + 2
    assert gram_cuda.REPLAYS["cross"] == before[1]["cross"] + 2
    with _build.counting_into(tally):
        for route in ("wgmma", "wgmma", "narrow"):  # a bucket's predict
            _build.count("gemm", MM.LAUNCHES)
            _build.count(f"gemm_{route}", MM.LAUNCHES)
    assert tally["gemm"] == 3 and tally["gemm_wgmma"] == 2
    assert tally["gemm_narrow"] == 1 and MM.LAUNCHES == before[2]
    _build.count("gemm", MM.LAUNCHES)
    assert MM.LAUNCHES["gemm"] == before[2]["gemm"] + 1
    MM.REPLAYS.update(before[0])
    gram_cuda.REPLAYS.update(before[1])
    MM.LAUNCHES.update(before[2])


def test_gemm_ctypes_signature_matches_the_c_entry_point():
    """`_build` declares one argtype per parameter of each of
    gemm_3xtf32.cu's C entry points (`gemm_3xtf32_wgmma`,
    `gemm_3xtf32_narrow`, `gemm_3xtf32_narrow_clusters`,
    `gemm_3xtf32_setup`), of the C type of each; the first design's
    `gemm_3xtf32` entry point and kernel are gone."""
    import ctypes
    import re

    with open(_build.GEMM_SOURCE) as f:
        src = f.read()
    c_types = {"int": ctypes.c_int, "float": ctypes.c_float,
               "long long": ctypes.c_longlong}
    entry = re.findall(r"^int (gemm_\w+)\(", src, re.M)
    assert sorted(entry) == sorted(n for n, _ in _build.GEMM_ENTRY_POINTS)
    assert "gemm_3xtf32_kernel" not in src and "int gemm_3xtf32(" not in src
    for name, argtypes in _build.GEMM_ENTRY_POINTS:
        params = re.search(rf"int {name}\((.*?)\)", src, re.S).group(1)
        params = [" ".join(p.split()) for p in params.split(",")
                  if p.strip()]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            kind = param.rsplit(" ", 1)[0]
            want = ctypes.c_void_p if "*" in param else c_types[kind]
            assert argtype is want, (name, param)


def test_one_nvcc_builds_both_sources_into_one_library(monkeypatch,
                                                        tmp_path):
    """Each source goes to its own nvcc with the library's flags, both
    started before either ends, and one link puts both objects into one
    library; ptxas's report is kept beside it; the cache key hashes both
    sources, so editing either one rebuilds."""
    from nngp_tpu_torch.ops import _build

    sources = []
    for name in ("gram.cu", "gemm_3xtf32.cu"):
        sources.append(tmp_path / name)
        sources[-1].write_text(f"// {name}\n")
    log = tmp_path / "argv"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho \"start $*\" >> {log}\n"
                    "case \" $* \" in *\" -c \"*) sleep 0.3;; esac\n"
                    "echo 'ptxas info    : Used 1 registers' >&2\n"
                    f"echo \"end $*\" >> {log}\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; "
                    "shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "SOURCES", tuple(map(str, sources)))
    first = _build.build()
    assert _build.is_built() and _build.build() == first
    events = log.read_text().splitlines()
    compiles = [e.split()[1:] for e in events
                if e.startswith("start") and " -c " in e]
    links = [e.split()[1:] for e in events
             if e.startswith("start") and " -shared " in e]
    assert len(compiles) == 2 and len(links) == 1 and len(events) == 6
    for argv, source in zip(compiles, sources):
        assert argv[:len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
        assert argv[-1] == str(source)
    # both compiles start before either ends; the link comes last
    assert [e.split()[0] for e in events[:4]] == ["start", "start", "end",
                                                   "end"]
    assert events[4].startswith("start") and " -shared " in events[4]
    objs = [argv[argv.index("-o") + 1] for argv in compiles]
    assert links[0][-2:] == objs
    with open(f"{first}.log") as f:
        assert f.read().count("Used 1 registers") == 2
    assert not any(os.path.exists(o) for o in objs)
    sources[1].write_text("// gemm_3xtf32.cu, edited\n")
    assert not _build.is_built()
    assert _build.build() != first
    assert len(log.read_text().splitlines()) == 12


# ------------------------------------------------ the Nystrom tier vs JAX
def _int_rows(n_rows, seed, d=20):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, (n_rows, d)).astype(np.float32)


@pytest.fixture(scope="module")
def rows32():
    rng = np.random.default_rng(0)
    return {"x": _int_rows(300, 1), "y": rng.uniform(0.0, 16.0, (300, 1))
            .astype(np.float32), "xt": _int_rows(40, 2),
            "x_new": _int_rows(30, 3),
            "y_new": rng.uniform(0.0, 16.0, (30, 1)).astype(np.float32)}


def _rel(got, want):
    got, want = np.asarray(n(got), np.float64), np.asarray(n(want),
                                                           np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_high_fit_moments_match_jax(rows32, get):
    """fit_nystrom(precision='high') in fp32 (panels of 77 rows, a ragged
    tail): c_raw, b_w and m1_w against JAX's 'high' fit, its predictions,
    an extend and forget(extend); the extend leaves the fit's moments as
    they were (the in-place accumulation runs on copies)."""
    kw = dict(num_inducing=32, get=get, panel_size=77, input_scale=1.0,
              precision="high")
    jpost = JN.fit_nystrom(jax_spec(SPEC), jnp.asarray(rows32["x"]),
                           jnp.asarray(rows32["y"]), **kw)
    post = fit_nystrom(SPEC, rows32["x"], rows32["y"], device="cpu", **kw)
    assert post.precision == "high" and jpost.precision == "high"
    names = ("c_raw", "b_w") + (("m1_w",) if get == "ntk" else ())
    for name in names:
        assert _rel(getattr(post, name), getattr(jpost, name)) \
            < MOMENT_RTOL[get], name
    for g, w in zip(post.predict_mean_std(torch.as_tensor(rows32["xt"])),
                    jpost.predict_mean_std(jnp.asarray(rows32["xt"]))):
        assert _rel(g, w) < PREDICT_RTOL
    c_before = post.c_raw.clone()
    ext = post.extend(rows32["x_new"], rows32["y_new"])
    jext = jpost.extend(jnp.asarray(rows32["x_new"]),
                        jnp.asarray(rows32["y_new"]))
    assert torch.equal(post.c_raw, c_before)
    assert ext.precision == "high"
    for name in names:
        assert _rel(getattr(ext, name), getattr(jext, name)) \
            < MOMENT_RTOL[get], name
    back = ext.forget(rows32["x_new"], rows32["y_new"])
    assert _rel(back.c_raw, post.c_raw) < 1e-5
    full = post.predict(torch.as_tensor(rows32["xt"]), compute_cov=True)
    jfull = jpost.predict(jnp.asarray(rows32["xt"]), compute_cov=True)
    for g, w in zip(full, jfull):
        assert _rel(g, w) < PREDICT_RTOL * 10


def test_high_differs_from_highest_only_at_fp32_rounding(rows32):
    """The 'high' fit is not the 'highest' one (the twin ran), and the two
    agree to fp32 rounding amplified by the whitening."""
    kw = dict(num_inducing=32, panel_size=77, input_scale=1.0, device="cpu")
    high = fit_nystrom(SPEC, rows32["x"], rows32["y"], precision="high",
                       **kw)
    highest = fit_nystrom(SPEC, rows32["x"], rows32["y"], **kw)
    assert not torch.equal(high.c_raw, highest.c_raw)
    assert _rel(high.c_raw, highest.c_raw) < 1e-5
    xt = torch.as_tensor(rows32["xt"])
    assert _rel(high.predict_mean_std(xt)[0],
                highest.predict_mean_std(xt)[0]) < PREDICT_RTOL


@pytest.mark.parametrize("moments", ["fp32", "df64"])
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_high_on_fp64_products_is_highest_bit_for_bit(rows32, get, moments):
    """fp64 posteriors give the same bits under 'high' as under 'highest'
    (predictions, moments, extend, the RPCholesky indices); so do the fp64
    moments of moments='df64' on fp32 rows, whose predict then runs its
    fp32 products in 3xTF32, as JAX's df64 predict runs them at HIGH."""
    dtype = np.float64 if moments == "fp32" else np.float32
    x, y = rows32["x"].astype(dtype), rows32["y"].astype(dtype)
    kw = dict(num_inducing=32, get=get, panel_size=77, moments=moments,
              device="cpu")
    a = fit_nystrom(SPEC, x, y, precision="high", **kw)
    b = fit_nystrom(SPEC, x, y, precision="highest", **kw)
    xt = torch.as_tensor(rows32["xt"].astype(dtype))
    a_ext, b_ext = a.extend(x[:20], y[:20]), b.extend(x[:20], y[:20])
    same = [(a.c_raw, b.c_raw), (a.b_w, b.b_w), (a_ext.c_raw, b_ext.c_raw)]
    near = list(zip([*a.predict(xt), *a_ext.predict_mean_std(xt)],
                    [*b.predict(xt), *b_ext.predict_mean_std(xt)]))
    if moments == "fp32":
        same, near = same + near, []
    for g, w in same:
        assert torch.equal(g, w)
    for g, w in near:
        assert _rel(g, w) < PREDICT_RTOL
    assert not near or any(not torch.equal(g, w) for g, w in near)
    if moments == "fp32":
        kw = dict(get=get, seed=1, block=8, device="cpu")
        np.testing.assert_array_equal(
            TN.select_inducing_rpchol(SPEC, x, 40, precision="high", **kw),
            TN.select_inducing_rpchol(SPEC, x, 40, **kw))


def test_high_leaves_tf32_off(rows32):
    """Every 'high' entry point leaves torch's TF32 switch as it found it
    (off), and no module of the port switches it on."""
    import ast
    import pathlib

    assert torch.backends.cuda.matmul.allow_tf32 is False
    post = fit_nystrom(SPEC, rows32["x"], rows32["y"], num_inducing=24,
                       precision="high", device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    post.predict(torch.as_tensor(rows32["xt"]))
    post.extend(rows32["x_new"], rows32["y_new"])
    TN.select_inducing_rpchol(SPEC, rows32["x"], 16, precision="high",
                              device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    root = pathlib.Path(TN.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and tgt.attr == "allow_tf32"):
                        assert isinstance(node.value, ast.Constant) and \
                            node.value.value is False, path


# ------------------------------------------------------------ RPCholesky
@pytest.mark.parametrize("get", ["nngp", "ntk"])
@pytest.mark.parametrize("seed", range(3))
def test_rpchol_high_indices_match_jax(get, seed):
    """select_inducing_rpchol(precision='high') on fp32 rows, the rpchol
    tests' clustered rows and integer rows: the same indices as JAX's
    'high' selection (both draw from the same numpy generator with
    probabilities from their residual diagonals, which 'high' moves by
    fp32 rounding only)."""
    clustered, _ = _skewed_data(seed=seed)
    for x in (clustered.astype(np.float32), _int_rows(200, seed + 10)):
        for m, block in ((24, 8), (40, 64)):
            kw = dict(get=get, seed=seed, block=block, precision="high")
            want = JN.select_inducing_rpchol(jax_spec(SPEC), jnp.asarray(x),
                                             m, **kw)
            got = TN.select_inducing_rpchol(SPEC, x, m, device="cpu", **kw)
            np.testing.assert_array_equal(got, want)


def test_fit_rpchol_high():
    """fit_nystrom(inducing='rpchol', precision='high') selects with 'high'
    and predicts what JAX's does."""
    x = _int_rows(200, 7)
    y = np.sin(x.sum(axis=1) / 1000.0)[:, None].astype(np.float32)
    kw = dict(num_inducing=24, inducing="rpchol", precision="high",
              input_scale=1.0, seed=2)
    post = fit_nystrom(SPEC, x, y, device="cpu", **kw)
    jpost = JN.fit_nystrom(jax_spec(SPEC), jnp.asarray(x), jnp.asarray(y),
                           **kw)
    np.testing.assert_array_equal(n(post.x_m), np.asarray(jpost.x_m))
    xt = _int_rows(20, 8)
    for g, w in zip(post.predict_mean_std(torch.as_tensor(xt)),
                    jpost.predict_mean_std(jnp.asarray(xt))):
        assert _rel(g, w) < PREDICT_RTOL


# ------------------------------------------------- forest_2048, fp32
@pytest.fixture(scope="module")
def forest_2048_q():
    """(x_tr, y_tr, x_te, y_te) of the parity gate's forest_2048 pins,
    fp32, and JAX's fp32 q-error (median, p95) at each precision."""
    from nngp_tpu_torch.data.workload import load_single_table_workload
    from nngp_tpu_torch.eval.qerror import symmetric_qerror
    from nngp_tpu_torch.eval.splits import train_test_val_split

    x, y, infos, _ = load_single_table_workload("workloads/forest_data",
                                                dtype=np.float64)
    x_tr, y_tr, _, x_te, y_te, *_ = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos)
    data = tuple(np.asarray(a, np.float32)
                 for a in (x_tr[:2048], y_tr[:2048], x_te))
    y_te = np.asarray(y_te).ravel()
    jax_q = {}
    for precision in ("highest", "high"):
        post = JN.fit_nystrom(jax_spec(SPEC), jnp.asarray(data[0]),
                              jnp.asarray(data[1]), num_inducing=256,
                              diag_reg=1e-3, seed=0, precision=precision)
        mean, _ = post.predict_mean_std(jnp.asarray(data[2]))
        q = symmetric_qerror(np.asarray(mean).ravel() - y_te)
        jax_q[precision] = (float(np.median(q)), float(np.quantile(q, 0.95)))
    return data, y_te, jax_q


FOREST_BAND = (5e-3, 1e-2)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_forest_2048_fp32_against_jax(forest_2048_q, precision):
    """The forest_2048 Nystrom fit (m = 256) in fp32 with fp32 moments:
    the port's q-error within FOREST_BAND of JAX's at the same precision.
    'highest' is the band's own case; 'high' is held to the same band."""
    from nngp_tpu_torch.eval.qerror import symmetric_qerror

    (x_tr, y_tr, x_te), y_te, jax_q = forest_2048_q
    post = fit_nystrom(SPEC, x_tr, y_tr, num_inducing=256, diag_reg=1e-3,
                       seed=0, precision=precision, device="cpu")
    mean, _ = post.predict_mean_std(torch.as_tensor(x_te))
    q = symmetric_qerror(n(mean).ravel() - y_te)
    med, p95 = float(np.median(q)), float(np.quantile(q, 0.95))
    assert med == pytest.approx(jax_q[precision][0], rel=FOREST_BAND[0])
    assert p95 == pytest.approx(jax_q[precision][1], rel=FOREST_BAND[1])


# ------------------------------------------------- checkpoints, Estimator
def test_high_checkpoint_both_ways_then_extend_and_grow(toy, tmp_path):
    """A JAX Estimator's Nystrom posterior refitted with precision='high'
    (grow_inducing refits at the posterior's precision) and saved restores
    in the port with precision 'high', predicts what JAX predicts, extends
    and grows without raising (before the port ran 'high', the grow raised
    NotImplementedError), and keeps 'high' through both; the port's
    checkpoint restores in JAX with 'high' and predicts what the port
    does; a port round trip is bit-equal."""
    jest, est = _pair(toy, nystrom_m=16, dtype=np.float32)
    lines = _mk_lines(np.random.default_rng(3), 40)
    for e in (jest, est):
        e.posterior = dataclasses.replace(e.posterior, precision="high")
        e.grow_inducing(lines, num_new=4)
        assert e.posterior.precision == "high"
    jest.save(str(tmp_path / "jax"))
    est.save(str(tmp_path / "port"))
    on_port = Estimator.restore(str(tmp_path / "jax"), device="cpu")
    on_jax = JaxEstimator.restore(str(tmp_path / "port"))
    assert on_port.posterior.precision == "high"
    assert on_jax.posterior.precision == "high"
    _close(on_port.predict(LINES), jest.predict(LINES), 2e-3)
    _close(on_jax.predict(LINES), est.predict(LINES), 2e-3)
    new = _mk_lines(np.random.default_rng(4), 6)
    on_port.extend_with_lines(new)
    on_jax.extend_with_lines(new)
    assert on_port.posterior.precision == "high"
    _close(on_port.predict(LINES), on_jax.predict(LINES), 2e-3)
    grown = on_port.grow_inducing(lines + new, num_new=4)
    on_jax.grow_inducing(lines + new, num_new=4)
    assert grown == on_port.posterior.num_inducing
    assert on_port.posterior.precision == "high"
    _close(on_port.predict(LINES), on_jax.predict(LINES), 2e-3)
    back = Estimator.restore(str(tmp_path / "port"), device="cpu")
    assert back.posterior.precision == "high"
    for g, w in zip(back.predict(LINES), est.predict(LINES)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the mesh
def test_mesh_high_on_two_gloo_ranks(rows32):
    """fit_nystrom(mesh=, precision='high') on two gloo CPU ranks (the
    twin on each): the summed per-panel deltas, an extend and forget
    through the mesh, against the fit without a mesh (the same products
    summed in another order: rel 1e-6) and against JAX's 'high' fit."""
    payload = {"spec": SPEC, "x": rows32["x"], "y": rows32["y"],
               "x_new": rows32["x_new"], "y_new": rows32["y_new"],
               "xt": rows32["xt"], "m": 24, "panel": 37}
    ranks = on_ranks(2, "nystrom_high", payload)
    jpost = JN.fit_nystrom(jax_spec(SPEC), jnp.asarray(rows32["x"]),
                           jnp.asarray(rows32["y"]), num_inducing=24,
                           panel_size=37, input_scale=1.0, precision="high")
    for r in ranks:
        assert r["precision"] == ("high", "high")
        assert r["num_train"] == (300, 330, 300)
        for g, w in zip(r["mesh"], r["plain"]):
            assert _rel(g, w) < 1e-6
        assert _rel(r["mesh"][0], jpost.c_raw) < MOMENT_RTOL["nngp"]
        assert _rel(r["mesh"][1], jpost.b_w) < MOMENT_RTOL["nngp"]
        for g, w in zip(r["mean_std"],
                        jpost.predict_mean_std(jnp.asarray(rows32["xt"]))):
            assert _rel(g, w) < PREDICT_RTOL
