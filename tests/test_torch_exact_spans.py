"""The exact fit's spans (`gp/posterior.py::fit_gp`: `exact.fit` around
`exact.prepare`, `exact.gram`, `exact.factor` and `exact.solve`) in its
dense, padded and column-block layouts, on the CPU: their names, nesting
and attrs; the prepare span's probe; nothing kept or allocated while the
recorder is off; a posterior bit-equal with the recorder on and off; and
the padded fit against the benchmark's plain exact reference
(`portbench/reference/exact.py`) in fp64."""

import numpy as np
import pytest
import torch

from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp import posterior as P
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.utils import profiling
from portbench.reference import exact as ref_exact
from portbench.tiers import kernel_spec

SPEC = KernelSpec(mlp(2))
STAGES = {"dense": ["exact.prepare", "exact.gram", "exact.factor",
                    "exact.solve"],
          "padded": ["exact.prepare", "exact.gram", "exact.factor",
                     "exact.solve"],
          "blocks": ["exact.prepare", "exact.factor", "exact.solve"]}


def _data(seed, n=100, d=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1000, (n, d)).astype(dtype),
            rng.standard_normal((n, 1)).astype(dtype),
            rng.uniform(0, 1000, (17, d)).astype(dtype))


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


def _fit_kwargs(layout, monkeypatch):
    if layout == "blocks":
        monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 64)
        monkeypatch.setattr(P, "_BLOCK_PANEL", 32)
    return {"pad_to": 130} if layout == "padded" else {}


@pytest.mark.parametrize("layout", ["dense", "padded", "blocks"])
def test_a_fit_spans_its_stages(layout, monkeypatch):
    x, y, _ = _data(1)
    kw = _fit_kwargs(layout, monkeypatch)
    post, spans = _recorded(lambda: fit_gp(SPEC, x, y, device="cpu", **kw))
    assert post.num_train == 100
    (fit,) = [s for s in spans if s.name == "exact.fit"]
    assert fit.parent == 0
    # a column-block fit counts its blocks (100 rows in blocks of 32) and
    # their storage, and spans each block and its steps under exact.factor
    counts = ({"blocks": 4, "factor_bytes": 8 * sum(
        (100 - s) * (min(s + 32, 100) - s) for s in range(0, 100, 32))}
        if layout == "blocks" else {})
    assert fit.attrs == {"rows": 100, "pad_to": kw.get("pad_to"),
                         "layout": layout, "dtype": "float64",
                         "get": "nngp", **counts}
    children = sorted((s for s in spans if s.parent == fit.id),
                      key=lambda s: s.t0)
    assert [s.name for s in children] == STAGES[layout]
    assert len(spans) == len(children) + 1 + 4 * counts.get("blocks", 0)
    assert all(fit.t0 <= s.t0 <= s.t1 <= fit.t1 for s in children)
    assert all(a.t1 <= b.t0 for a, b in zip(children, children[1:]))
    storage = kw.get("pad_to", 100)
    by = {s.name: s.attrs for s in children}
    assert by["exact.prepare"] == {"rows": 100, "probe": "skipped"}
    # the dense and padded layouts factor the storage's block: in place
    # by cuSOLVER on the card, by cholesky_ex and a copy back on the CPU
    in_place = {} if layout == "blocks" else {"in_place": False}
    assert by["exact.factor"] == {"rows": 100, "storage_rows": storage,
                                  "factor_rows": 100, "layout": layout,
                                  **in_place}
    assert by["exact.solve"] == {"rows": 100}
    if layout != "blocks":
        assert by["exact.gram"] == {"rows": 100, "storage_rows": storage}


@pytest.mark.parametrize("layout", ["dense", "padded", "blocks"])
def test_the_recorder_leaves_the_posterior_bit_equal(layout, monkeypatch):
    x, y, xt = _data(2)
    kw = _fit_kwargs(layout, monkeypatch)
    off = fit_gp(SPEC, x, y, device="cpu", **kw)
    on, _ = _recorded(lambda: fit_gp(SPEC, x, y, device="cpu", **kw))
    l_off = off.l.to_dense() if layout == "blocks" else off.l
    l_on = on.l.to_dense() if layout == "blocks" else on.l
    assert torch.equal(l_off, l_on)
    for name in ("x_train", "y_train", "alpha", "reg", "row_mask"):
        a, b = getattr(off, name), getattr(on, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    for a, b in zip(off.predict_mean_std(torch.as_tensor(xt)),
                    on.predict_mean_std(torch.as_tensor(xt))):
        assert torch.equal(a, b)


def test_off_a_fit_keeps_and_allocates_no_span(monkeypatch):
    made = []
    init = profiling.Span.__init__

    def counting(self, name, attrs):
        made.append(name)
        init(self, name, attrs)

    monkeypatch.setattr(profiling.Span, "__init__", counting)
    profiling.take()
    x, y, _ = _data(3)
    for kw in ({}, {"pad_to": 120}):
        fit_gp(SPEC, x, y, device="cpu", **kw)
    assert made == [] and profiling.take() == ([], 0)


@pytest.mark.parametrize("case, probe", [
    ("fp64", "skipped"), ("fp32", "host"), ("fp32_tensor", "host"),
    ("biased", "skipped"), ("given", "given")])
def test_the_prepare_span_names_its_probe(case, probe, monkeypatch):
    dtype = np.float64 if case == "fp64" else np.float32
    x, y, _ = _data(4, dtype=dtype)
    spec = KernelSpec(mlp(1, b_std=0.1)) if case == "biased" else SPEC
    kw = {"input_scale": 1.0} if case == "given" else {}
    if case == "given":
        def no_probe(rows, layers):
            raise AssertionError("probed although input_scale was given")
        monkeypatch.setattr(P, "_auto_input_scale", no_probe)
    if case == "fp32_tensor":
        x = torch.as_tensor(x)
    _, spans = _recorded(lambda: fit_gp(spec, x, y, device="cpu", **kw))
    (prep,) = [s for s in spans if s.name == "exact.prepare"]
    assert prep.attrs == {"rows": 100, "probe": probe}
    (fit,) = [s for s in spans if s.name == "exact.fit"]
    assert fit.attrs["dtype"] == np.dtype(dtype).name


def test_a_failed_factor_closes_its_spans():
    """A Gram that is not positive definite (a negative ridge far below
    its diagonal) raises from inside exact.factor: every span still
    ends."""
    x, y, _ = _data(5, n=40)
    _, spans = _recorded(lambda: pytest.raises(
        P.FactorError, fit_gp, SPEC, x, y, diag_reg=-1e12,
        diag_reg_absolute_scale=True, device="cpu"))
    assert [s.name for s in spans] == ["exact.prepare", "exact.gram",
                                       "exact.factor", "exact.fit"]
    assert all(s.t1 is not None for s in spans)


CONFIG = {"kernel": [["dense", 512, 1.0, 0.0], ["relu"],
                     ["dense", 1, 1.0, 0.0]],
          "diag_reg": 1e-3, "get": "nngp"}


@pytest.mark.parametrize("n_rows, pad_to", [(96, 96), (120, 160)])
def test_a_padded_fit_matches_the_plain_reference(n_rows, pad_to):
    """fit_gp(pad_to=) of seeded rows against the benchmark's plain
    exact reference, fp64: mean and std within 1e-10 of the reference's
    largest."""
    x, y, xt = _data(6, n=n_rows, d=61)
    post = fit_gp(kernel_spec(CONFIG), x, y, diag_reg=CONFIG["diag_reg"],
                  get=CONFIG["get"], pad_to=pad_to, device="cpu")
    mean, std = post.predict_mean_std(torch.as_tensor(xt))
    ref = ref_exact.fit(CONFIG, torch.as_tensor(x),
                        torch.as_tensor(y).reshape(-1))
    want_mean, want_std = ref_exact.predict(CONFIG, ref, torch.as_tensor(xt))
    for got, want in ((mean, want_mean), (std, want_std)):
        got, want = got.reshape(-1).numpy(), want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.max(np.abs(want)))
