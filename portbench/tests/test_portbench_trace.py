"""The busy/idle union, the idle gaps named by host spans, and the
per-layer readers on a synthetic trace."""

from types import SimpleNamespace

import pytest

from portbench.lib import registry
from portbench.lib.devtrace import Spans, Traced
from portbench.lib.roofline import gemm_bound, pair_bound, panels


def test_union_gaps_and_names():
    rec = [("gram_kernel<double, false>", 1.0, 1.2), ("trsm", 1.1, 1.5),
           ("copy", 1.7, 1.8), ("outside", 0.0, 0.5)]
    t = Traced(rec, 1.0, 2.0)
    assert t.busy == [[1.0, 1.5], [1.7, 1.8]]
    assert t.busy_s == pytest.approx(0.6)
    assert t.window_s == pytest.approx(1.0)
    assert t.gaps() == [(1.5, 1.7), (1.8, 2.0)]
    spans = Spans()
    spans.add("predict_fn", 1.0, 1.75)
    spans.add("encode", 1.5, 1.72)
    got = dict(t.idle_by_span(spans, "batcher_wait"))
    assert got == pytest.approx({"encode": 0.2, "batcher_wait": 0.2})
    assert t.kernel_seconds(("gram_", "kernel")) == pytest.approx((0.2, 1))
    assert t.top_ops()[0] == ["trsm", pytest.approx(0.4)]


def test_bounds():
    # the dot of a 64 x 14,896 x 61 fp64 launch is bound by its bytes
    s, by = pair_bound(64, 14896, 61, "float64")
    assert by == "bytes"
    assert s == pytest.approx(((64 + 14896) * 61 + 64 * 14896) * 8 / 3.35e12)
    s, by = gemm_bound(16384, 2048, 2048)
    assert by == "operations" and s == pytest.approx(
        6.0 * 16384 * 2048 * 2048 / 495e12)
    assert gemm_bound(2048, 1, 16384)[1] == "bytes"
    assert panels(90000, 16384) == [16384] * 5 + [8080]


def ctx_serve():
    spans = Spans()
    records = []
    for i in range(10):
        t = 1.0 + 0.1 * i
        spans.add("predict_fn", t, t + 0.08, lines=1900)
        spans.add("encode", t, t + 0.01, rows=1900)
        records.append(("void gram_kernel<double, false>(...)", t + 0.011,
                        t + 0.014))
        records.append(("trsm", t + 0.015, t + 0.07))
    return SimpleNamespace(
        config={"dtype": "float64", "mfu_peak": "fp64"},
        counts={"rows_encoded_window": 19000, "train_rows": 10800,
                "feature_dim": 61, "storage_rows": 14896},
        spans=spans, traced=Traced(records, 1.0, 2.0))


def ctx_refit():
    cfg = {"window_rows": 90000, "panel_rows": 16384, "num_inducing": 2048,
           "dtype": "float32", "mfu_peak": "tf32"}
    records = []
    for i in range(2):
        t = 1.0 + 0.03 * i
        records += [("gram_kernel<float, false>", t, t + 0.002),
                    ("gemm_3xtf32_wgmma_kernel", t + 0.002, t + 0.02),
                    ("gemm_3xtf32_narrow_kernel", t + 0.02, t + 0.0206)]
    return SimpleNamespace(
        config=cfg, counts={"fits": 30, "traced_fits": 2,
                            "feature_dim": 61},
        spans=Spans(), traced=Traced(records, 1.0, 1.06))


@pytest.mark.parametrize("name", [
    "batch_rows.serve", "encode_us_per_row.serve", "mfu.serve",
    "gram_cross_roofline.serve", "device_idle.serve", "mfu.refit",
    "wgmma_roofline.refit", "narrow_roofline.refit",
    "gram_cross_roofline.refit", "device_idle.refit"])
def test_readers_read_a_share_or_a_count(name):
    ctx = ctx_serve() if name.endswith(".serve") else ctx_refit()
    value = registry.metric_reader(name)(ctx)
    assert value is not None and value > 0
    if name.split(".")[0].endswith(("roofline", "idle")) or "mfu" in name:
        assert value <= 100.0


def test_readers_return_nothing_without_records():
    empty = SimpleNamespace(config={"dtype": "float64", "mfu_peak": "fp64",
                                    "window_rows": 10, "panel_rows": 10,
                                    "num_inducing": 4},
                            counts={"traced_fits": 1, "feature_dim": 61,
                                    "storage_rows": 100},
                            spans=Spans(), traced=Traced([], 0.0, 1.0))
    for name in ("gram_cross_roofline.serve", "wgmma_roofline.refit",
                 "narrow_roofline.refit", "gram_cross_roofline.refit",
                 "batch_rows.serve", "encode_us_per_row.serve"):
        assert registry.metric_reader(name)(empty) is None, name


def test_clock_offset_from_anchors_and_markers():
    from portbench.lib.devtrace import MARK_KERNEL, clock_offset

    marks = [10.0, 10.5]                  # anchors' perf_counter (s)
    anchors = [(0, 10.0e6 + 300.0), (1, 10.5e6 + 300.0)]
    # the device records sit 2,000 us later than the host anchors say
    device_marks = [11.0, 11.04, 11.08]
    records = [(MARK_KERNEL + "(long)", m * 1e6 + 2300.0 + 4.0, 0.0)
               for m in device_marks]
    records.append(("trsm", 11.01e6 + 2300.0, 0.0))
    assert clock_offset(records, anchors, marks, device_marks) == \
        pytest.approx(2304.0)
    assert clock_offset(records[-1:], anchors, marks, []) == \
        pytest.approx(300.0)
