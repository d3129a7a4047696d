"""The exact fit's factor in its own storage (`gp/posterior.py::fit_gp`,
dense and padded layouts): the Gram written into the leading (n, n) block
of the (p, p) factor storage, factored there (`_factor_block_`: cuSOLVER's
potrf on the card, `ops/cusolver.py::potrf_lower_`; `cholesky_ex` and a
copy back on the CPU) and solved for alpha on that block.

The expected values are the route the fit took before: `cholesky_ex` of
the (n, n) Gram in its own tensor, alpha's two solves on that factor, the
factor then written beside the pad's unit rows (`_old_fit` below).

No JAX here, so that the card's tests run on a machine without it:

    python -m pytest --noconftest -m card tests/test_torch_inplace_factor.py

They skip on a machine without an NVIDIA GPU."""

import numpy as np
import pytest
import torch

from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp import posterior as P
from nngp_tpu_torch.models.kernel_spec import KernelSpec, mlp
from nngp_tpu_torch.ops.cublas import trsm_lower_t
from nngp_tpu_torch.ops.cusolver import potrf_lower_
from nngp_tpu_torch.ops.gram_cuda import gram_sym
from nngp_tpu_torch.ops.linalg import FactorError
from nngp_tpu_torch.utils import profiling

SPEC = KernelSpec(mlp(2))
N, PAD = 100, 160
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _data(n=N, d=5, seed=71, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(0, 1000, (n, d)).astype(dtype)),
            torch.as_tensor(rng.standard_normal((n, 1)).astype(dtype)))


def _old_fit(x, y, pad_to=None, input_scale=1.0, get="nngp",
             diag_reg=1e-3):
    """(factor, info, alpha, k_tt_nngp) as the fit made them before: the
    ridged Gram in its own (n, n) tensor, `cholesky_ex`, alpha's solves,
    then [L, 0; 0, I] and zero alpha rows at pad_to."""
    x = x * (1.0 / input_scale)
    n = x.shape[0]
    diag = P.diag_eval(SPEC.layers, x, ("nngp", "ntk"))
    reg = P.solve_ridge(diag, get, diag_reg, False)
    k_tt = None
    if get == "nngp":
        k = gram_sym(SPEC, x, "nngp", diag_add=reg, diag=diag)
    else:
        k_tt, k = gram_sym(SPEC, x, ("nngp", "ntk"), diag_add=reg,
                           diag=diag)
    l, info = torch.linalg.cholesky_ex(k)
    z = torch.linalg.solve_triangular(l, y, upper=False)
    alpha = torch.linalg.solve_triangular(l.mT, z, upper=True)
    if pad_to is not None:
        out = l.new_empty((pad_to, pad_to))
        out[:n, :n] = l
        out[:n, n:] = 0.0
        out[n:] = 0.0
        out.diagonal()[n:] = 1.0
        l = out
        alpha = torch.cat([alpha, alpha.new_zeros((pad_to - n, 1))])
    return l, int(info), alpha, k_tt


def _close(got, want, rtol):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale


def _assert_layout(l, n):
    """The strict upper triangle of the real block and the pad's off
    blocks exactly zero, the pad's diagonal exactly one."""
    p = l.shape[0]
    assert not torch.triu(l[:n, :n], diagonal=1).any()
    assert not l[:n, n:].any() and not l[n:, :n].any()
    assert torch.equal(l[n:, n:], torch.eye(p - n, dtype=l.dtype,
                                            device=l.device))


# ---------------------------------------------------------- the CPU
@pytest.mark.parametrize("pad_to", [PAD, None], ids=["padded", "dense"])
@pytest.mark.parametrize("dtype, input_scale", [(np.float64, 1.0),
                                                (np.float32, 2.0)])
def test_the_fit_factors_its_storage_as_the_old_route(pad_to, dtype,
                                                      input_scale):
    x, y = _data(dtype=dtype)
    post = fit_gp(SPEC, x, y, pad_to=pad_to, input_scale=input_scale)
    l, info, alpha, _ = _old_fit(x, y, pad_to, input_scale)
    p = N if pad_to is None else pad_to
    assert info == 0 and post.l.shape == (p, p) and post.alpha.shape == (p, 1)
    assert post.l.mT.is_contiguous()        # column-major, cuSOLVER's order
    rtol = RTOL[post.l.dtype]
    _close(post.l, l, rtol)
    _close(post.alpha, alpha, rtol)
    _assert_layout(post.l, N)
    assert not post.alpha[N:].any()


def test_an_ntk_fit_keeps_its_own_nngp_gram():
    """get='ntk': the NTK Gram is factored in the storage, the NNGP half
    goes to `k_tt_nngp`'s own (n, n) tensor."""
    x, y = _data()
    post = fit_gp(SPEC, x, y, get="ntk")
    l, _, alpha, k_tt = _old_fit(x, y, get="ntk")
    assert post.k_tt_nngp.shape == (N, N) and post.k_tt_nngp.is_contiguous()
    assert post.k_tt_nngp.untyped_storage().data_ptr() \
        != post.l.untyped_storage().data_ptr()
    assert torch.equal(post.k_tt_nngp, k_tt)
    _close(post.l, l, 1e-12)
    _close(post.alpha, alpha, 1e-12)
    _assert_layout(post.l, N)


@pytest.mark.parametrize("pad_to", [PAD, None], ids=["padded", "dense"])
@pytest.mark.parametrize("diag_reg", [-0.5, -1e-3])
def test_a_negative_ridge_fails_at_cholesky_ex_s_order(pad_to, diag_reg):
    x, y = _data()
    _, info, _, _ = _old_fit(x, y, diag_reg=diag_reg)
    assert 0 < info <= N
    with pytest.raises(FactorError) as err:
        fit_gp(SPEC, x, y, diag_reg=diag_reg, pad_to=pad_to)
    assert (err.value.op, err.value.order, err.value.n) == ("fit", info, N)
    assert err.value.diag_reg == diag_reg


@pytest.mark.parametrize("pad_to", [PAD, None], ids=["padded", "dense"])
def test_the_factor_span_says_the_cpu_factors_a_copy(pad_to):
    x, y = _data()
    profiling.take()
    profiling.enable()
    try:
        fit_gp(SPEC, x, y, pad_to=pad_to)
    finally:
        profiling.disable()
    spans, _ = profiling.take()
    (factor,) = [s for s in spans if s.name == "exact.factor"]
    assert factor.attrs["in_place"] is False


@pytest.mark.parametrize("make, match", [
    (lambda: torch.eye(8, dtype=torch.float64).mT, "CUDA"),
    (lambda: torch.eye(8, dtype=torch.float64)[:6, :6], "contiguous"),
    (lambda: torch.eye(16, dtype=torch.float64).mT[::2, ::2], "contiguous"),
    (lambda: torch.eye(8, dtype=torch.float16), "fp32 / fp64"),
    (lambda: torch.ones((4, 6), dtype=torch.float64), "square"),
], ids=["cpu", "row-major", "strided-columns", "fp16", "not-square"])
def test_potrf_lower_refuses(make, match):
    with pytest.raises(ValueError, match=match):
        potrf_lower_(make())


def test_trsm_lower_t_refuses_a_cpu_factor():
    with pytest.raises(ValueError, match="CUDA"):
        trsm_lower_t(torch.eye(4, dtype=torch.float64),
                     torch.ones((4, 1), dtype=torch.float64))


# ---------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuSOLVER's and cuBLAS's in-place "
                    "calls exist only on the card")
    return torch.device("cuda")


def _spd_storage(p, device, dtype, seed=7):
    """A symmetric positive definite (p, p) matrix, column-major."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((p, p)) / np.sqrt(p)
    return torch.as_tensor(a @ a.T + np.eye(p), device=device).to(dtype).mT


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_potrf_lower_factors_a_leading_block_in_place(dtype):
    """The leading (2,200, 2,200) block of a column-major (3,000, 3,000)
    matrix, lda = 3,000, against `torch.linalg.cholesky` of a contiguous
    copy (to k eps of the factor's largest entry); the rest of the storage
    untouched, the strict upper triangle zero, no buffer of k^2 bytes
    allocated."""
    device = _card()
    p, k = 3000, 2200
    full = _spd_storage(p, device, dtype)
    before = full.clone()
    want = torch.linalg.cholesky(full[:k, :k].clone())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    info = potrf_lower_(full[:k, :k])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    assert int(info) == 0
    assert peak < k * k * full.element_size()
    eps = torch.finfo(dtype).eps
    _close(full[:k, :k], want, k * eps)
    assert not torch.triu(full[:k, :k], diagonal=1).any()
    assert torch.equal(full[:k, k:], before[:k, k:])
    assert torch.equal(full[k:], before[k:])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_potrf_lower_reports_an_indefinite_block_s_order(dtype):
    device = _card()
    p, k, bad = 3000, 2200, 1500
    full = _spd_storage(p, device, dtype)
    full[bad, bad] = -1000.0
    _, want = torch.linalg.cholesky_ex(full[:k, :k].clone())
    info = potrf_lower_(full[:k, :k])
    assert int(info) == int(want) == bad + 1


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["row-major", "column-major"])
def test_trsm_lower_t_reads_a_leading_block_in_place(dtype, layout):
    """L^-T b of the leading (2,200, 2,200) block of a (3,000, 3,000)
    factor, lda = 3,000, against `torch.linalg.solve_triangular` of a
    contiguous copy."""
    device = _card()
    p, k, m = 3000, 2200, 3
    full = torch.linalg.cholesky(_spd_storage(p, device, torch.float64))
    full = full.to(dtype).contiguous()
    if layout == "column-major":
        full = full.mT.contiguous().mT
    b = torch.as_tensor(np.random.default_rng(8).standard_normal((k, m)),
                        device=device, dtype=dtype)
    want = torch.linalg.solve_triangular(full[:k, :k].mT.contiguous(), b,
                                         upper=True)
    got = trsm_lower_t(full[:k, :k], b)
    _close(got, want, 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.card
@pytest.mark.parametrize("pad_to", [1100, None], ids=["padded", "dense"])
def test_a_card_fit_factors_its_storage_in_place(pad_to):
    """A fit on the card: `exact.factor` reads in_place=True, and the
    factor and alpha match the CPU fit's."""
    device = _card()
    x, y = _data(n=900)
    profiling.take()
    profiling.enable()
    try:
        post = fit_gp(SPEC, x.to(device), y.to(device), pad_to=pad_to)
    finally:
        profiling.disable()
    spans, _ = profiling.take()
    (factor,) = [s for s in spans if s.name == "exact.factor"]
    assert factor.attrs["in_place"] is True
    cpu = fit_gp(SPEC, x, y, pad_to=pad_to)
    _close(post.l.cpu(), cpu.l, 1e-10)
    _close(post.alpha.cpu(), cpu.alpha, 1e-8)
    _assert_layout(post.l, 900)
