"""The padded exact predict's live order (`gp.posterior.live_rows`,
`LIVE_STEP`), the solve that reads a factor's leading block in place
(`ops.cublas.trsm_lower`), and the serving buckets that follow the live
order (`serve/graphs.py`: `BucketGraphs.recaptures`, the `live_rows` attr
of the `graphs.run` and `graphs.capture` spans).

No JAX here, so that the card's tests run on a machine without it:

    python -m pytest --noconftest -m card tests/test_torch_live_rows.py

They skip on a machine without an NVIDIA GPU, where the buckets run
eagerly and the solve has no cuBLAS."""

import numpy as np
import pytest
import torch

from nngp_tpu_torch.gp import fit_gp, fit_nystrom
from nngp_tpu_torch.gp import posterior as TP
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.serve.graphs import BucketGraphs
from nngp_tpu_torch.utils import profiling

SPEC = KernelSpec(mlp(2))


def _data(n, n_test=64, d=5, seed=61):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1000, (n, d)), rng.standard_normal((n, 1)),
            rng.uniform(0, 1000, (n_test, d)))


def _fit(x, y, pad_to=None, device="cpu", dtype=np.float64, **kw):
    return fit_gp(SPEC, torch.as_tensor(x.astype(dtype), device=device),
                  torch.as_tensor(y.astype(dtype), device=device),
                  pad_to=pad_to, **kw)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuBLAS's solve and the buckets' "
                    "CUDA graphs exist only on the card")
    return torch.device("cuda")


# ---------------------------------------------------------- the CPU
@pytest.mark.parametrize("n_real, pad_to, want", [
    (300, None, 300),        # dense: every storage row
    (300, 1100, 512),        # padded: the real rows rounded up to a step
    (256, 1100, 256),        # on a step
    (1050, 1100, 1100),      # the step capped by the storage
    (300, 300, 300),         # every storage row real
])
def test_live_rows_by_layout(n_real, pad_to, want):
    assert TP.LIVE_STEP == 256
    x, y, _ = _data(n_real)
    post = _fit(x, y, pad_to)
    assert TP.live_rows(post) == want
    assert post.num_padded == (n_real if pad_to is None else pad_to)


def test_live_rows_of_a_column_block_posterior(monkeypatch):
    monkeypatch.setattr(TP, "_BLOCK_LAYOUT_MIN_N", 100)
    x, y, _ = _data(300)
    post = _fit(x, y)
    assert isinstance(post.l, TP.BlockLowerTriangular)
    assert TP.live_rows(post) == post.num_padded == 300


@pytest.mark.parametrize("layout", ["dense", "blocks", "padded"])
def test_the_predict_reads_the_live_prefix_and_no_copy(layout, monkeypatch):
    """Dense and column-block posteriors hand the kernels and the solve
    their own tensors; a padded one views the leading k = live_rows rows
    of its storage (the same memory, the factor's columns p apart)."""
    if layout == "blocks":
        monkeypatch.setattr(TP, "_BLOCK_LAYOUT_MIN_N", 100)
    x, y, xt = _data(300)
    post = _fit(x, y, 1100 if layout == "padded" else None)
    seen = {}
    gram_cross, tri_solve = TP.gram_cross, TP._tri_solve

    def spy_cross(spec, a, b, *args, **kw):
        seen["x_train"] = b
        return gram_cross(spec, a, b, *args, **kw)

    def spy_solve(l, b, transpose=False):
        seen["l"] = l
        return tri_solve(l, b, transpose)

    monkeypatch.setattr(TP, "gram_cross", spy_cross)
    monkeypatch.setattr(TP, "_tri_solve", spy_solve)
    post.predict_mean_std(torch.as_tensor(xt))
    if layout != "padded":
        assert seen["x_train"] is post.x_train and seen["l"] is post.l
        return
    k, p = 512, 1100
    assert seen["x_train"].shape == (k, 5)
    assert seen["x_train"].data_ptr() == post.x_train.data_ptr()
    assert seen["l"].shape == (k, k) and seen["l"].stride() == (1, p)
    assert seen["l"].data_ptr() == post.l.data_ptr()


def test_graphs_run_records_the_live_order_across_extends():
    """On the CPU the buckets run eagerly: the `graphs.run` span names the
    live order each run read, and nothing is captured or dropped."""
    x, y, xt = _data(600)
    t = torch.as_tensor
    post = _fit(x[:300], y[:300], 1100)
    graphs = BucketGraphs(post)
    want = post.predict_mean_std(t(xt))
    profiling.take()
    profiling.enable()
    try:
        got = graphs.predict(xt)
        for s, e in ((300, 400), (400, 600)):
            with graphs.lock:
                assert post.extend(t(x[s:e]), t(y[s:e]), bucket=128) is post
            graphs.predict(xt)
    finally:
        profiling.disable()
    spans, dropped = profiling.take()
    runs = [s.attrs["live_rows"] for s in spans if s.name == "graphs.run"]
    assert dropped == 0 and runs == [512, 512, 768]
    assert graphs.recaptures == graphs.captures == 0 and not graphs.captured
    np.testing.assert_array_equal(got[0], want[0].reshape(-1).numpy())
    np.testing.assert_array_equal(got[1], want[1].reshape(-1).numpy())


def test_a_nystrom_run_has_no_live_order():
    x, y, xt = _data(200)
    post = fit_nystrom(SPEC, x, y, num_inducing=16, panel_size=64,
                       device="cpu")
    graphs = BucketGraphs(post)
    profiling.take()
    profiling.enable()
    try:
        graphs.predict(xt)
    finally:
        profiling.disable()
    spans, _ = profiling.take()
    assert [s.attrs["live_rows"] for s in spans
            if s.name == "graphs.run"] == [None]


# ---------------------------------------------------------- the card
@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trsm_lower_reads_a_leading_block_in_place(dtype):
    """cuBLAS's solve of the leading (k, k) block of a (p, p) factor, lda =
    p, against `torch.linalg.solve_triangular` of a contiguous copy; no
    (k, k) buffer is allocated."""
    from nngp_tpu_torch.ops.cublas import trsm_lower

    device = _card()
    p, k, m = 3000, 2200, 300
    rng = np.random.default_rng(7)
    a = rng.standard_normal((p, p)) / np.sqrt(p)
    full = torch.linalg.cholesky(torch.as_tensor(a @ a.T + np.eye(p),
                                                 device=device)).to(dtype)
    b = torch.as_tensor(rng.standard_normal((m, k)), device=device,
                        dtype=dtype).mT
    want = torch.linalg.solve_triangular(full[:k, :k].clone(), b,
                                         upper=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    got = trsm_lower(full[:k, :k], b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    assert got.shape == (k, m) and peak < k * k * full.element_size()
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    # a column-major leading block: cuBLAS's own order
    col = full.mT.contiguous().mT
    assert col.stride() == (1, p)
    got = trsm_lower(col[:k, :k], b)
    assert float((got - want).abs().max()) <= rtol * scale
    with pytest.raises(ValueError, match="contiguous"):
        trsm_lower(full[:2000:2, :2000:2], b)


@pytest.mark.card
@pytest.mark.parametrize("dtype, input_scale", [(np.float64, 1.0),
                                                (np.float32, 1.0),
                                                (np.float32, 2.0)])
def test_an_extend_across_a_step_captures_the_buckets_again(dtype,
                                                            input_scale):
    """A padded posterior served from CUDA graphs, before and after an
    in-place extend that crosses a LIVE_STEP: each replay equals the eager
    predict bit for bit, and in fp64 its stripped posterior's to 1e-12 (the
    mean relative to sum |K_*t| |alpha|, the variance to its largest
    value, as in tests/test_torch_padded.py); the crossing drops the
    buckets once (`recaptures`); the pool holds no more than a dense
    posterior's of the same storage, and where the solve runs in L's dtype
    (on cuBLAS, the prefix read in place) less than one (k, k) copy of it.
    The fp64 variance of an fp32 factor converts it _WIDE_BLOCK columns at
    a time, as for any fp32 posterior with a prescale."""
    device = _card()
    x, y, xt = _data(8192, n_test=128)     # the buckets' own sizes
    t = lambda a: torch.as_tensor(a.astype(dtype), device=device)  # noqa
    post = fit_gp(SPEC, t(x[:6100]), t(y[:6100]), diag_reg=1e-2,
                  input_scale=input_scale, pad_to=8192)
    graphs = BucketGraphs(post)
    itemsize = post.x_train.element_size()

    def check(k):
        assert TP.live_rows(post) == k
        stripped = post.strip_padding()
        for rows in (xt[:64], xt):
            got = graphs.predict(rows.astype(dtype))
            eager = post.predict_mean_std(t(rows))
            ref = stripped.predict_mean_std(t(rows))
            cross = TP.gram_cross(SPEC, t(rows) / input_scale,
                                  stripped.x_train, "nngp")
            scales = ((cross.abs() @ stripped.alpha.abs()).max(),
                      ref[1].abs().max())
            for g, e, r, scale in zip(got, eager, ref, scales):
                e, r = e.reshape(-1).cpu().numpy(), r.reshape(-1).cpu().numpy()
                np.testing.assert_array_equal(g, e)
                if dtype == np.float64:
                    np.testing.assert_allclose(g, r, rtol=0,
                                               atol=1e-12 * float(scale))
        assert graphs.captured == [64, 128]
        if not post._raw64:
            assert graphs.pool_bytes() < k * k * itemsize
        return graphs.pool_bytes()

    pools = [check(6144)]
    assert graphs.recaptures == 0 and graphs.captures == 2
    with graphs.lock:
        assert post.extend(t(x[6100:6200]), t(y[6100:6200]),
                           bucket=128) is post
    pools.append(check(6400))
    assert graphs.recaptures == 1 and graphs.captures == 4
    dense = fit_gp(SPEC, t(x), t(y), diag_reg=1e-2,
                   input_scale=input_scale)
    dense_graphs = BucketGraphs(dense)
    for rows in (xt[:64], xt):
        dense_graphs.predict(rows.astype(dtype))
    print(f"pool bytes at k = 6144, 6400 {pools}; dense 8192 "
          f"{dense_graphs.pool_bytes()}")
    assert pools[-1] <= dense_graphs.pool_bytes()
