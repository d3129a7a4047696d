"""The exact tier's rolling refit (`synth6-exact-fp64.refit`) at a tiny
size on the CPU: a sound run is correct and reports refit_ms and setup_s;
its fp32 control and two faults in the fit are not correct. And its three
readers (`mfu.exact-refit`, `gram_sym_roofline.exact-refit`,
`factor_roofline.exact-refit`) on a synthetic trace."""

from types import SimpleNamespace

import pytest

from portbench.lib import registry
from portbench.lib.devtrace import Spans, Traced
from portbench.tests import cells

CELL = "synth6-exact-fp64.refit"
TINY = ({"log_rows": 2400, "window_rows": 1600, "pad_to": 1664,
         "check_rows": 512}, {})


@pytest.fixture
def tiny():
    cells.TINY[CELL] = TINY
    try:
        yield
    finally:
        del cells.TINY[CELL]


def test_a_sound_run_is_correct(tiny, tmp_path):
    res = cells.run(CELL, tmp_path)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"refit_ms", "setup_s"}


def test_the_fp32_control_is_not_correct(tiny, tmp_path):
    cell = registry.load_cell(CELL)
    over, program = registry.kind(cell.mix["kind"]).control(cell.config)
    assert over == {"dtype": "float32"} and program is None
    res = cells.run(CELL, tmp_path, config=over, program=program)
    assert not res["correct"], res["check"]


def ridge_off(runner):
    """The fit with diag_reg 1.25 times the configuration's."""
    cfg = dict(runner.cfg, diag_reg=1.25 * runner.cfg["diag_reg"])
    return runner.tier.fit(cfg, runner.run.device)


def last_rows_dropped(runner):
    """The fit of the window without its last 1% of rows."""
    fit = runner.tier.fit(runner.cfg, runner.run.device)

    def short(x, y):
        keep = len(x) - len(x) // 100
        return fit(x[:keep], y[:keep])
    return short


@pytest.mark.parametrize("fault", [ridge_off, last_rows_dropped])
def test_a_fault_in_the_fit_is_not_correct(fault, tiny, tmp_path):
    res = cells.run(CELL, tmp_path, program=fault)
    assert not res["correct"], res["check"]


# ------------------------------------------------------------- readers
N, D, FITS = 10800, 61, 2
GRAM = "void (anonymous namespace)::gram_kernel<double, false, false, 1>"


def ctx_exact(records, window=(1.0, 1.1)):
    return SimpleNamespace(
        config={"window_rows": N, "pad_to": 14896, "dtype": "float64",
                "mfu_peak": "fp64"},
        counts={"fits": 40, "traced_fits": FITS, "feature_dim": D},
        spans=Spans(), traced=Traced(records, *window))


def fit_records(t):
    """One fit's device records from t (s): the copy, PyTorch's fill,
    the Gram, cuSOLVER's factor, a fill, the two solves, a read-back."""
    return [("Memcpy HtoD (Pageable -> Device)", t, t + 0.001),
            ("void at::native::vectorized_elementwise_kernel<4, "
             "at::native::FillFunctor<double>>", t + 0.001, t + 0.003),
            (GRAM, t + 0.003, t + 0.004),
            ("void potrf_alg2_cta_lower<double>", t + 0.004, t + 0.030),
            ("Memset (Device)", t + 0.030, t + 0.0305),
            ("void trsm_left_kernel<double>", t + 0.031, t + 0.032),
            ("void trsm_left_kernel<double>", t + 0.032, t + 0.033),
            ("Memcpy DtoH (Device -> Pageable)", t + 0.033, t + 0.0331)]


def test_the_readers_read_their_hand_computed_shares():
    ctx = ctx_exact(fit_records(1.0) + fit_records(1.05))
    read = {name: registry.metric_reader(name) for name in (
        "mfu.exact-refit", "gram_sym_roofline.exact-refit",
        "factor_roofline.exact-refit")}
    flops = N * (N + 1.0) * D + N ** 3 / 3.0 + 2.0 * N * N
    assert read["mfu.exact-refit"](ctx) == pytest.approx(
        100.0 * FITS * flops / 0.1 / 67e12)
    # bound by its bytes: (n d + n^2) 8 bytes at 3.35 TB/s, over 1 ms
    sym = (N * D + N * N) * 8 / 3.35e12
    assert sym > N * (N + 1.0) * D / 67e12
    assert read["gram_sym_roofline.exact-refit"](ctx) == pytest.approx(
        100.0 * FITS * sym / (FITS * 0.001))
    # potrf's 26 ms and the solves' 2 ms a fit; the gram kernel, copies,
    # fills and at::native kernels left out
    factor = (N ** 3 / 3.0 + 2.0 * N * N) / 67e12
    assert read["factor_roofline.exact-refit"](ctx) == pytest.approx(
        100.0 * FITS * factor / (FITS * 0.028))
    for name, value in ((n, r(ctx)) for n, r in read.items()):
        assert 0 < value <= 100.0, name


def test_the_factor_share_stays_under_the_padding_cap():
    """A factor at the fp64 peak over the padded storage rows reads
    (n / p)^3 of it: 38.1% at 10,800 of 14,896."""
    p = 14896
    seconds = (p ** 3 / 3.0 + 2.0 * p * p) / 67e12
    ctx = ctx_exact([("void potrf_alg2_cta_lower<double>", 1.0,
                      1.0 + seconds)], window=(1.0, 1.1))
    ctx.counts["traced_fits"] = 1
    value = registry.metric_reader("factor_roofline.exact-refit")(ctx)
    assert value == pytest.approx(38.1, abs=0.05)


@pytest.mark.parametrize("name", ["mfu.exact-refit",
                                  "gram_sym_roofline.exact-refit",
                                  "factor_roofline.exact-refit"])
def test_the_readers_return_nothing_without_a_trace(name):
    ctx = ctx_exact([])
    ctx.traced = None
    assert registry.metric_reader(name)(ctx) is None
    # a trace whose launches are all left out: no time to divide by
    if name != "mfu.exact-refit":
        ctx = ctx_exact([("Memcpy HtoD (Pageable -> Device)", 1.0, 1.01)])
        assert registry.metric_reader(name)(ctx) is None
