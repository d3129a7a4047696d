"""The exact tier's column-block fit as a measured deployment (the cell
`synth6big-exact-fp64.refit-live`), on the CPU at a small size with the
layout switch forced (`gp.posterior._BLOCK_LAYOUT_MIN_N`, `_BLOCK_PANEL`):

- the benchmark's column-block plain reference
  (`portbench/reference/exact_blocks.py`) against its dense one;
- the program's column-block `fit_gp` through the tier
  (`portbench/tiers/exact_blocks.py`) within the configuration's limits of
  that reference; an fp32 fit and a fit with 1.25 times the ridge outside
  them; a fit that is not column blocks refused;
- the spans of the column-block factor (`exact.block` and its gram,
  update and factor steps under `exact.factor`, the `blocks` and
  `factor_bytes` counts of `exact.fit`): their attrs, nothing kept or
  allocated while the recorder is off, a posterior bit-equal either way,
  every span closed when a block's factor fails;
- the `live_refit` kind at a tiny size: one finished posterior at a time,
  the live one judged after it is freed, a run whose fits all fail judged
  not correct without a crash;
- the four readers the cell reports beside `device_idle.refit` on a
  synthetic trace: the exact refit's `mfu.exact-refit` and
  `factor_roofline.exact-refit`, which read the blocks layout as they read
  the padded one, and the cell's own `gram_roofline.exact-blocks` and
  `block_idle_ms.exact-blocks`.

Rows and labels are seeded: they are this model's weights."""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp import posterior as P
from nngp_tpu_torch.ops import linalg as L
from nngp_tpu_torch.ops.linalg import BlockLowerTriangular, FactorError
from nngp_tpu_torch.utils import profiling
from portbench.lib import harness, registry
from portbench.lib.devtrace import Spans, Traced
from portbench.reference import exact as ref_exact
from portbench.reference import exact_blocks as ref_blocks
from portbench.reference import judge, kernel
from portbench.tests import cells
from portbench.tiers import kernel_spec

CELL = "synth6big-exact-fp64.refit-live"
PANEL = 64


def _config():
    return registry.load_cell(CELL).config


def _data(seed, n, d=61, dtype=np.float64):
    """Rows in [0, 1) as the chunk-normed encoder's, log2 cardinalities
    as labels, and 37 probe rows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, d)).astype(dtype),
            rng.uniform(0, 20, (n, 1)).astype(dtype),
            rng.uniform(0, 1, (37, d)).astype(dtype))


@pytest.fixture
def forced(monkeypatch):
    """The column-block layout from 64 rows, in blocks of PANEL columns."""
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 64)
    monkeypatch.setattr(P, "_BLOCK_PANEL", PANEL)


def _gaps(config, post, x, y, xp):
    tier = registry.tier("exact_blocks")
    return tier.judge_fit(config, [post], torch.as_tensor(x),
                          torch.as_tensor(y).reshape(-1),
                          torch.as_tensor(xp))


# ----------------------------------------------------------- reference
@pytest.mark.parametrize("n, block, rows", [(300, 64, 50), (517, 100, 64),
                                            (700, 128, 1000)])
def test_the_block_reference_is_the_dense_one(n, block, rows, monkeypatch):
    monkeypatch.setattr(ref_blocks, "BLOCK", block)
    monkeypatch.setattr(ref_blocks, "ROWS", rows)
    cfg = _config()
    x, y, xp = (torch.as_tensor(a) for a in _data(n, n))
    got = ref_blocks.predict(cfg, ref_blocks.fit(cfg, x, y.reshape(-1)), xp)
    want = ref_exact.predict(cfg, ref_exact.fit(cfg, x, y.reshape(-1)), xp)
    for g, w in zip(got, want):
        assert torch.max(torch.abs(g - w)) <= 1e-10 * torch.max(torch.abs(w))


# ------------------------------------------------------------- the tier
def test_the_program_is_within_the_limits_of_the_reference(forced):
    cfg = _config()
    x, y, xp = _data(1, 420)
    post = registry.tier("exact_blocks").fit(cfg, "cpu")(x, y)
    assert len(post.l.blocks) == -(-420 // PANEL)
    ok, check = judge.verdict(_gaps(cfg, post, x, y, xp), cfg["limits"])
    assert ok, check


@pytest.mark.parametrize("fault", ["float32", "ridge x 1.25"])
def test_a_fault_in_the_fit_exceeds_a_limit(fault, forced):
    cfg = _config()
    x, y, xp = _data(2, 420)
    fit_cfg = dict(cfg)
    if fault == "float32":
        fit_cfg["dtype"] = "float32"
        x32, y32 = x.astype(np.float32), y.astype(np.float32)
        post = registry.tier("exact_blocks").fit(fit_cfg, "cpu")(x32, y32)
    else:
        fit_cfg["diag_reg"] = 1.25 * cfg["diag_reg"]
        post = registry.tier("exact_blocks").fit(fit_cfg, "cpu")(x, y)
    assert isinstance(post.l, BlockLowerTriangular)
    ok, check = judge.verdict(_gaps(fit_cfg | {"diag_reg": cfg["diag_reg"]},
                                    post, x, y, xp), cfg["limits"])
    assert not ok, check


def test_the_tier_refuses_a_factor_that_is_not_blocks():
    x, y, _ = _data(3, 120)
    tier = registry.tier("exact_blocks")
    with pytest.raises(TypeError, match="not as column blocks"):
        tier.fit(_config(), "cpu")(x, y)


def test_the_judge_frees_the_posterior_before_the_reference(forced,
                                                           monkeypatch):
    cfg = _config()
    x, y, xp = _data(4, 200)
    post = registry.tier("exact_blocks").fit(cfg, "cpu")(x, y)
    alive = weakref.ref(post)
    held, post = [post], None
    seen = []
    fit = ref_blocks.fit

    def checked(config, rows, labels):
        gc.collect()
        seen.append(alive() is None)
        return fit(config, rows, labels)

    monkeypatch.setattr(ref_blocks, "fit", checked)
    registry.tier("exact_blocks").judge_fit(
        cfg, held, torch.as_tensor(x), torch.as_tensor(y).reshape(-1),
        torch.as_tensor(xp))
    assert seen == [True] and held == []


# --------------------------------------------------------------- spans
def _recorded(fn):
    profiling.take()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    spans, dropped = profiling.take()
    assert dropped == 0
    return out, spans


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_a_block_fit_spans_each_block_and_its_steps(get, forced,
                                                    monkeypatch):
    monkeypatch.setattr(L, "_PANEL_ROWS", 100)
    n = 300
    x, y, _ = _data(5, n)
    spec = kernel_spec(_config())
    post, spans = _recorded(lambda: fit_gp(spec, x, y, get=get,
                                           device="cpu"))
    starts = list(range(0, n, PANEL)) + [n]
    (fit,) = [s for s in spans if s.name == "exact.fit"]
    assert fit.attrs["blocks"] == len(starts) - 1 == len(post.l.blocks)
    assert fit.attrs["factor_bytes"] == 8 * sum(
        (n - s) * (e - s) for s, e in zip(starts, starts[1:]))
    (factor,) = [s for s in spans if s.name == "exact.factor"]
    blocks = sorted((s for s in spans if s.name == "exact.block"),
                    key=lambda s: s.t0)
    assert len(blocks) == len(starts) - 1
    for k, (b, s, e) in enumerate(zip(blocks, starts, starts[1:])):
        assert b.parent == factor.id
        assert factor.t0 <= b.t0 <= b.t1 <= factor.t1
        assert b.attrs == {"block": k, "rows": n - s, "width": e - s,
                           "updates": k,
                           "solves": len(range(e - s, n - s, 100))}
        steps = sorted((c for c in spans if c.parent == b.id),
                       key=lambda c: c.t0)
        assert [c.name for c in steps] == ["exact.block.gram",
                                           "exact.block.update",
                                           "exact.block.factor"]
        assert all(b.t0 <= c.t0 <= c.t1 <= b.t1 for c in steps)
        assert all(c.attrs == {} for c in steps)
    assert len(spans) == 4 + 4 * len(blocks)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_off_a_block_fit_allocates_no_span_and_is_bit_equal(get, forced,
                                                            monkeypatch):
    x, y, xt = _data(6, 250)
    spec = kernel_spec(_config())
    on, _ = _recorded(lambda: fit_gp(spec, x, y, get=get, device="cpu"))
    made = []
    init = profiling.Span.__init__

    def counting(self, name, attrs):
        made.append(name)
        init(self, name, attrs)

    monkeypatch.setattr(profiling.Span, "__init__", counting)
    off = fit_gp(spec, x, y, get=get, device="cpu")
    assert made == [] and profiling.take() == ([], 0)
    assert len(off.l.blocks) == len(on.l.blocks) == 4
    for a, b in zip(off.l.blocks, on.l.blocks):
        assert torch.equal(a, b)
    assert torch.equal(off.alpha, on.alpha)
    for a, b in zip(off.predict_mean_std(torch.as_tensor(xt)),
                    on.predict_mean_std(torch.as_tensor(xt))):
        assert torch.equal(a, b)


def test_a_failed_block_factor_closes_every_span(forced):
    """A negative ridge between the smallest eigenvalue of the first
    block's square and that of the whole Gram: the first block factors,
    a later one fails, and every span still ends."""
    n = 320
    x, y, _ = _data(7, n)
    cfg = _config()
    k = kernel.sym(cfg["kernel"], torch.as_tensor(x))
    low = [float(torch.linalg.eigvalsh(k[:m, :m])[0]) for m in (PANEL, n)]
    assert low[0] > 1.5 * low[1]
    ridge = -0.5 * (low[0] + low[1])
    err, spans = _recorded(lambda: pytest.raises(
        FactorError, fit_gp, kernel_spec(cfg), x, y, diag_reg=ridge,
        diag_reg_absolute_scale=True, device="cpu"))
    failed = (err.value.order - 1) // PANEL
    assert failed >= 1
    blocks = [s for s in spans if s.name == "exact.block"]
    assert [b.attrs["block"] for b in blocks] == list(range(failed + 1))
    assert all(s.t1 is not None for s in spans)
    assert [s.name for s in spans[-4:]] == ["exact.block.factor",
                                            "exact.block", "exact.factor",
                                            "exact.fit"]
    assert profiling.current() is profiling.NO_SPAN


# ---------------------------------------------------------------- kind
TINY = ({"log_rows": 1200, "window_rows": 500, "check_rows": 256}, {})


@pytest.fixture
def tiny(forced, monkeypatch):
    # this suite's conftest loads JAX for the comparisons with the JAX
    # package; the harness's guard against it in a run's process is held
    # by the benchmark's own tests, which load none
    monkeypatch.setattr(harness, "FORBIDDEN", ())
    cells.TINY[CELL] = TINY
    try:
        yield
    finally:
        del cells.TINY[CELL]


def test_a_run_holds_one_live_posterior_and_judges_it_freed(tiny, tmp_path,
                                                            monkeypatch):
    made, alive_at_fit, alive_at_ref, judged = [], [], [], []

    def alive():
        gc.collect()
        return sum(r() is not None for r in made)

    def program(runner):
        fit = runner.tier.fit(runner.cfg, runner.run.device)
        judge_fit = runner.tier.judge_fit

        def tracked(x, y):
            alive_at_fit.append(alive())
            post = fit(x, y)
            made.append(weakref.ref(post))
            return post

        def judged_fit(cfg, held, x, y, xp):
            judged.append(held[0] is made[-1]())
            return judge_fit(cfg, held, x, y, xp)

        runner.tier.judge_fit = judged_fit
        return tracked

    ref_fit = ref_blocks.fit

    def ref_checked(config, x, y):
        alive_at_ref.append(alive())
        return ref_fit(config, x, y)

    monkeypatch.setattr(ref_blocks, "fit", ref_checked)
    # 503 lines leave the window's starts 1-3 after the warm fit's 0: the
    # run ends on them, after three fits whatever the machine's speed
    res = cells.run(CELL, tmp_path, seconds=60.0, program=program,
                    config={"log_rows": 503})
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] == len(made) - 1 == 3
    assert set(res["metrics"]) == {"refit_ms", "setup_s"}
    # the warm fit finds none; every later fit runs beside the live one
    assert alive_at_fit[0] == 0 and set(alive_at_fit[1:]) == {1}
    assert judged == [True] and alive_at_ref == [0]


def test_a_run_whose_fits_all_fail_is_not_correct(tiny, tmp_path):
    def program(runner):
        def fit(x, y):
            raise FactorError("fit", 7, len(x), torch.float32)
        return fit

    res = cells.run(CELL, tmp_path, seconds=0.3, program=program)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    assert all(v["value"] == float("inf") for v in res["check"].values())


def test_the_fp32_control_is_not_correct(tiny, tmp_path):
    cell = registry.load_cell(CELL)
    over, program = registry.kind(cell.mix["kind"]).control(cell.config)
    assert over == {"dtype": "float32"} and program is None
    res = cells.run(CELL, tmp_path, seconds=0.3, config=over)
    assert not res["correct"], res["check"]


# ------------------------------------------------------------- readers
N, D, FITS, WIDTH = 90000, 61, 2, 2048
GRAM = "void (anonymous namespace)::gram_kernel<double, false, false, 1>"
SYM = "void (anonymous namespace)::gram_kernel<double, true, false, 1>"


def _ctx(records, spans=(), window=(1.0, 1.1), **counts):
    items = Spans()
    for name, a, b in spans:
        items.add(name, a, b)
    return SimpleNamespace(
        config={"window_rows": N, "dtype": "float64", "mfu_peak": "fp64"},
        counts=dict({"fits": 7, "traced_fits": FITS, "feature_dim": D,
                     "blocks": 44, "block_columns": WIDTH}, **counts),
        spans=items, traced=Traced(records, *window))


RECORDS = [("Memcpy HtoD (Pageable -> Device)", 1.000, 1.001),
           (SYM, 1.001, 1.002), (GRAM, 1.002, 1.006),
           ("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n", 1.006, 1.030),
           ("void at::native::elementwise_kernel<128, 2>", 1.030, 1.031),
           ("void potrf_alg2_cta_lower<double>", 1.032, 1.040),
           ("void trsm_right_kernel<double>", 1.040, 1.048),
           ("Memset (Device)", 1.048, 1.049),
           (SYM, 1.050, 1.051), (GRAM, 1.052, 1.055),
           ("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n", 1.055, 1.090)]
# the device busy from 1.000 to 1.031, 1.032 to 1.049, 1.050 to 1.051,
# 1.052 to 1.090: idle 1.031-1.032, 1.049-1.050, 1.051-1.052, 1.090-1.1


def _bound(m, n):
    """The least seconds of one Gram launch of an (m, n) output of
    D-wide fp64 rows: its bytes at 3.35 TB/s or its FLOPs at 67
    TFLOP/s."""
    return max(((m + n) * D + m * n) * 8 / 3.35e12, 2.0 * D * m * n / 67e12)


def test_the_readers_read_their_hand_computed_shares():
    ctx = _ctx(RECORDS, spans=[("exact.block", 1.0305, 1.0495),
                               ("exact.block.factor", 1.031, 1.049),
                               ("exact.block", 1.0495, 1.0515)])
    read = {name: registry.metric_reader(name) for name in (
        "mfu.exact-refit", "factor_roofline.exact-refit",
        "gram_roofline.exact-blocks", "block_idle_ms.exact-blocks")}
    flops = N * (N + 1.0) * D + N ** 3 / 3.0 + 2.0 * N * N
    assert read["mfu.exact-refit"](ctx) == pytest.approx(
        100.0 * FITS * flops / 0.1 / 67e12)
    # the GEMMs' 24 + 35 ms, potrf's 8 and the trsm's 8: 75 ms
    factor = (N ** 3 / 3.0 + 2.0 * N * N) / 67e12
    assert read["factor_roofline.exact-refit"](ctx) == pytest.approx(
        100.0 * FITS * factor / 0.075)
    # 44 squares (43 of 2,048 columns, the last 1,936) and 43 panels
    # below them, over the Gram kernels' 9 ms
    bound = sum(_bound(min(WIDTH, N - s), min(WIDTH, N - s))
                for s in range(0, N, WIDTH))
    bound += sum(_bound(N - s - WIDTH, WIDTH)
                 for s in range(0, N - WIDTH, WIDTH))
    assert read["gram_roofline.exact-blocks"](ctx) == pytest.approx(
        100.0 * FITS * bound / 0.009)
    # the gaps at 1.031-1.032, 1.049-1.050 and 1.051-1.052 lie in a
    # block by their midpoints; the one after 1.090 does not
    assert read["block_idle_ms.exact-blocks"](ctx) == pytest.approx(
        1e3 * 0.003 / FITS)


@pytest.mark.parametrize("name", ["mfu.exact-refit",
                                  "factor_roofline.exact-refit",
                                  "gram_roofline.exact-blocks",
                                  "block_idle_ms.exact-blocks"])
def test_the_readers_return_nothing_without_a_trace(name):
    ctx = _ctx(RECORDS, spans=[("exact.block", 1.0, 1.1)])
    ctx.traced = None
    assert registry.metric_reader(name)(ctx) is None
    ctx = _ctx(RECORDS, spans=[("exact.block", 1.0, 1.1)], traced_fits=0)
    assert registry.metric_reader(name)(ctx) is None


def test_the_block_idle_reads_nothing_without_program_spans():
    """A program without the block spans (a tree older than them): the
    harness's own spans alone."""
    read = registry.metric_reader("block_idle_ms.exact-blocks")
    assert read(_ctx(RECORDS, spans=[("fit", 1.0, 1.1)])) is None
    ctx = _ctx(RECORDS)
    ctx.spans = None
    assert read(ctx) is None
