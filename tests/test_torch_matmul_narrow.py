"""The 3xTF32 GEMM's narrow kernel and the padded layouts that put every
wide product on the wgmma route whatever its row stride
(`nngp_tpu_torch.ops.matmul`, `csrc/gemm_3xtf32.cu`), and the Nystrom
tier's 'high' path at an inducing width that is not a multiple of 4, on
the CPU.

The kernels run only on the card, where `chip_smoke.py` phase 17 holds
them to fp64, their plain twin and torch.matmul fp32. What decides and
shapes their launches is plain Python, held here:

  - `launch_plan`: no route but 'wgmma', 'wgmma_n64' and 'narrow', for
    any shape; the narrow plan fills one wave at 132 SMs at the tier's
    one-column shapes (b += psi^T y at the 16,384-row panel and at the 90k
    fit's 8,080-row tail panel, the predict's mean at 8,192 rows), also
    when the card holds fewer clusters than 132 / S, and walks row blocks
    when they outnumber the resident clusters;
  - `padded_empty` / `padded_copy` / `_tma_operand`: row strides TMA can
    address (multiples of 4 floats), values unchanged, and an operand
    whose rows are 2,050 floats apart copied once into such a buffer;
  - the tier at m = 250 under 'high': the operands it hands to
    `matmul_3xtf32` in the fit, extend, forget, predict (variance and
    full covariance) and grow are addressable by TMA as they lie, so the
    wrapper copies none of them;
  - the tier at m = 250, with whiten 'chol' and 'eigh', against JAX's
    'high', which computes full fp32 dots on the CPU: after the fit, an
    extend, forget(extend) and grow_inducing, each moment and prediction
    at most 3x as far from JAX's as the port's 'highest' on the same rows
    (at least test_torch_matmul_3xtf32.py's rel 5e-6 (nngp) / 5e-4 (ntk)
    of the largest moment and 1e-4 of the largest prediction); the
    padding changes no value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.nystrom as JN
from nngp_tpu_torch.gp import fit_nystrom
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from nngp_tpu_torch.ops import matmul as MM
from tests.test_torch_common import jax_spec, n

SMS = 132
SPEC = reference_kernel()
M_ODD = 250                   # inducing rows: rows 1,000 bytes apart
MOMENT_RTOL = {"nngp": 5e-6, "ntk": 5e-4}
# the ridge of the m = 250 comparison, and its floor on the predictions:
# a larger ridge than the default 1e-3, whose solve stage amplifies fp32
# moment rounding to ~4e-4 between the two packages at this m
M250_REG = 0.1
M250_PREDICT_RTOL = 1e-4
# the tier's one-column products: b += psi^T y at the 16,384-row panel and
# at the 90k fit's tail panel, the predict's mean at an 8,192-row chunk
NARROW_SHAPES = ((2048, 1, 16384), (2048, 1, 8080), (8192, 1, 2048))
# clusters of S blocks resident at once: 132 // S, and a card whose
# graphics clusters hold fewer clusters of 8 than that
RESIDENT = {"even": None,
            "fewer": lambda bm, s: {1: 132, 2: 66, 4: 30, 8: 15}[s]}


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("n_cols", [1, 2, 16, 17, 64, 65, 2050])
def test_no_route_but_wgmma_and_narrow(n_cols):
    """Every shape plans the wgmma kernel (128 x 64 tiles up to 64
    columns) or, at most 16 columns wide, the narrow one: the first
    design's 'wide' and 'narrow' mma.sync tiles are gone."""
    assert set(MM.ROUTE_OF.values()) == set(MM.ROUTES) == {"wgmma", "narrow"}
    for m in (1, 17, 2050, 16384):
        for k in (0, 1, 2050):
            plan = MM.launch_plan(m, n_cols, k, SMS)
            want = ("narrow" if n_cols <= MM.NARROW_MAX_N else
                    "wgmma_n64" if n_cols <= MM.N64_MAX_N else "wgmma")
            assert plan.shape == want
            assert MM.ROUTE_OF[plan.shape] in ("wgmma", "narrow")
            assert 1 <= plan.blocks <= SMS


def test_a_row_stride_of_2050_plans_wgmma():
    """A K_pm panel, a basis and a psi whose rows are 2,050 floats apart:
    the product plans the wgmma route; the wrapper hands TMA a copy with a
    row stride of 2,052 (16-byte multiples), equal in value, for an
    operand as it lies and for its transpose view alike."""
    gen = torch.Generator().manual_seed(0)
    k_pm = torch.randn((64, 2050), generator=gen)
    w = torch.randn((2050, 2050), generator=gen)
    assert MM.launch_plan(64, 2050, 2050, SMS).shape == "wgmma"
    for t, rows, cols, trans in ((k_pm, 64, 2050, False),
                                 (w, 2050, 2050, False),
                                 (k_pm.mT, 2050, 64, True)):
        assert MM.tma_stride(*MM.operand_layout(t, rows, cols), rows,
                             cols) is None
        staged, got_trans, ld = MM._tma_operand(t, rows, cols)
        assert got_trans == trans and ld == 2052
        assert torch.equal(staged, t)
        stored = staged.mT if trans else staged
        assert stored.stride() == (2052, 1)
    # psi^T y, psi laid out by the tier: addressable as it lies
    psi = MM.padded_empty(16384, 2050)
    laid, trans, ld = MM._tma_operand(psi.mT, 2050, 16384)
    assert laid.data_ptr() == psi.data_ptr() and trans and ld == 2052
    assert MM.launch_plan(2050, 1, 16384, SMS).shape == "narrow"


@pytest.mark.parametrize("residency", sorted(RESIDENT))
@pytest.mark.parametrize("m,n_cols,k", NARROW_SHAPES)
def test_narrow_plan_fills_one_wave(m, n_cols, k, residency):
    """The narrow kernel's plan at the tier's one-column shapes: its grid
    never exceeds one wave at 132 SMs (every block resident: at most the
    resident clusters of its size; "fewer": what the occupancy API gave on
    an H100, 30 clusters of 4 and 15 of 8), a cluster's splits are whole
    stages, each split at least NARROW_MIN_STAGES of them, and the splits
    cover K. Each shape runs 128 blocks, one row block each: b += psi^T y
    64 row blocks of 32 rows x 2 splits (16 x 8 of 128 rows would need 16
    clusters of 8), the mean 128 row blocks of 64."""
    held = RESIDENT[residency]
    plan = MM.launch_plan(m, n_cols, k, SMS, held)
    cap = (held or (lambda bm, s: SMS // s))(plan.bm, plan.splits)
    step = MM.narrow_stage_k(plan.bm)
    assert plan.shape == "narrow" and plan.tiles == -(-m // plan.bm)
    assert plan.bm in MM.NARROW_ROWS and plan.splits in MM.NARROW_CLUSTERS
    assert plan.blocks <= SMS and plan.blocks // plan.splits <= cap
    assert plan.blocks == plan.tiles * plan.splits == 128
    assert (plan.bm, plan.splits) == ((64, 1) if m == 8192 else (32, 2))
    assert plan.k_split % step == 0
    assert (plan.splits - 1) * plan.k_split < k <= plan.splits * plan.k_split
    if plan.splits > 1:
        assert plan.k_split >= MM.NARROW_MIN_STAGES * step


def test_narrow_plan_walks_row_blocks_past_the_resident_clusters():
    """More row blocks than the card holds clusters: one split each (a
    split cluster takes one row block), and the grid is the resident
    blocks, each walking several row blocks; an empty K is one split of
    one stage that reads nothing."""
    plan = MM.launch_plan(100000, 1, 2048, SMS)
    assert (plan.tiles, plan.splits, plan.blocks, plan.bm) == (782, 1, SMS,
                                                               128)
    plan = MM.launch_plan(100000, 1, 2048, SMS, lambda bm, s: 120 // s)
    assert plan.blocks == 120 and plan.splits == 1
    assert MM.launch_plan(5, 3, 0, SMS) == ("narrow", 1, 1,
                                            MM.narrow_stage_k(128), 1, 128)


@pytest.mark.parametrize("n_cols,nb", [(1, 1), (2, 4), (4, 4), (5, 16),
                                       (16, 16)])
def test_narrow_b_width(n_cols, nb):
    """B is padded to the narrow kernel's widths 1, 4 or 16."""
    assert MM.narrow_nb(n_cols) == nb


# ------------------------------------------------------ padded layouts
@pytest.mark.parametrize("cols", [1, 2, 3, 4, 250, 2050])
def test_padded_layouts(cols):
    """`padded_empty`: rows tma_cols(cols) = cols rounded up to 4 floats
    apart; `padded_copy`: the tensor itself when TMA can address it, else
    an equal tensor laid out so."""
    t = MM.padded_empty(7, cols)
    assert t.shape == (7, cols)
    assert t.stride() == (MM.tma_cols(cols), 1)
    assert MM.tma_cols(cols) % 4 == 0 and cols <= MM.tma_cols(cols) < cols + 4
    assert MM.padded_copy(t) is t
    x = torch.arange(7.0 * cols).reshape(7, cols)
    got = MM.padded_copy(x)
    assert torch.equal(got, x)
    assert (got is x) == (cols % 4 == 0)
    assert got.stride(0) % 4 == 0


# ---------------------------------------------------- the tier at m = 250
def _rows(n_rows, seed, d=20):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, (n_rows, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    return {"x": _rows(600, 5), "y": rng.uniform(0.0, 16.0, (600, 1))
            .astype(np.float32), "xt": _rows(41, 6), "x_new": _rows(30, 7),
            "y_new": rng.uniform(0.0, 16.0, (30, 1)).astype(np.float32),
            "grow": _rows(5, 8)}


def _addressable(t, rows, cols):
    return MM.tma_stride(*MM.operand_layout(t, rows, cols), rows,
                         cols) is not None


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_high_tier_hands_tma_addressable_operands(data, get, monkeypatch):
    """Every 'high' product of the tier at m = 250 (rank 250: rows 1,000
    bytes apart) reads operands TMA addresses as they lie (A always, B of
    the wide products), in the fit (panels of 77 rows, a ragged tail),
    extend, forget, predict (mean and variance, full covariance) and
    grow_inducing to m = 255; the bases, ic and M1 are laid out so (row
    stride 252), with their logical shapes."""
    calls = []
    plain = MM.matmul_3xtf32_plain

    def spy(a, b, out=None, alpha=1.0, beta=0.0):
        m, k = a.shape
        cols = b.shape[1]
        calls.append((tuple(a.shape), cols, _addressable(a, m, k),
                      cols <= MM.NARROW_MAX_N or _addressable(b, k, cols)))
        return plain(a, b, out, alpha, beta)

    monkeypatch.setattr(MM, "matmul_3xtf32_plain", spy)
    post = fit_nystrom(SPEC, data["x"], data["y"], num_inducing=M_ODD,
                       get=get, panel_size=77, input_scale=1.0,
                       precision="high", device="cpu")
    assert post.rank == M_ODD
    for name in ("w_solve", "ic") + (("w_kmm", "m1_w") if get == "ntk"
                                     else ()):
        t = getattr(post, name)
        assert t.shape[1] == M_ODD and t.stride() == (252, 1), name
    xt = torch.as_tensor(data["xt"])
    post.predict_mean_std(xt)
    post.predict(xt, compute_cov=True)
    ext = post.extend(data["x_new"], data["y_new"])
    ext.forget(data["x_new"], data["y_new"])
    grown = post.grow_inducing(data["grow"], data["x"], data["y"])
    assert grown.num_inducing == M_ODD + 5
    grown.predict(xt, compute_cov=True)
    assert len(calls) > 20
    bad = [c for c in calls if not (c[2] and c[3])]
    assert not bad, bad


@pytest.mark.parametrize("get,whiten", [("nngp", "chol"), ("ntk", "chol"),
                                        ("nngp", "eigh"), ("ntk", "eigh")])
def test_high_m250_matches_jax(data, get, whiten):
    """fit_nystrom(precision='high') in fp32 at m = 250 against JAX's
    'high' fit on the same rows: the moments and the predictions (mean,
    std), after the fit, an extend, forget(extend) and grow_inducing by 5
    rows; with whiten='eigh' the two packages keep the same rank. Each
    difference from JAX may be at most 3x the port's 'highest' one on the
    same rows (at least rel 5e-6 / 5e-4 of the largest moment for nngp /
    ntk, 1e-4 of the largest prediction): fp32 rounding, which the
    whitening amplifies with m and the eigh basis most (the eigh moments
    of 'highest' differ from JAX's by 9e-6 (nngp) / 1.1e-3 (ntk) here),
    separates the packages, and 'high' may not add more than that."""
    kw = dict(num_inducing=M_ODD, get=get, panel_size=77, input_scale=1.0,
              whiten=whiten, diag_reg=M250_REG)
    jpost = JN.fit_nystrom(jax_spec(SPEC), jnp.asarray(data["x"]),
                           jnp.asarray(data["y"]), precision="high", **kw)
    post = fit_nystrom(SPEC, data["x"], data["y"], device="cpu",
                       precision="high", **kw)
    base = fit_nystrom(SPEC, data["x"], data["y"], device="cpu", **kw)
    assert post.rank == base.rank == jpost.w_solve.shape[1] <= M_ODD
    names = ("c_raw", "b_w") + (("m1_w",) if get == "ntk" else ())
    floors = [MOMENT_RTOL[get]] * len(names) + [M250_PREDICT_RTOL] * 2
    xt = torch.as_tensor(data["xt"])

    def rel(g, w):
        g, w = np.asarray(n(g), np.float64), np.asarray(n(w), np.float64)
        return float(np.max(np.abs(g - w)) / np.max(np.abs(w)))

    def rels(p, jp):
        return ([rel(getattr(p, name), getattr(jp, name)) for name in names]
                + [rel(g, w) for g, w in zip(
                    p.predict_mean_std(xt),
                    jp.predict_mean_std(jnp.asarray(data["xt"])))])

    def same(p, ref, jp, stage):
        for got, was, floor in zip(rels(p, jp), rels(ref, jp), floors):
            assert got <= max(3.0 * was, floor), (stage, got, was)

    same(post, base, jpost, "fit")
    new = (data["x_new"], data["y_new"])
    jnew = tuple(jnp.asarray(a) for a in new)
    ext, bext, jext = post.extend(*new), base.extend(*new), jpost.extend(*jnew)
    same(ext, bext, jext, "extend")
    same(ext.forget(*new), bext.forget(*new), jext.forget(*jnew), "forget")
    grow = (data["grow"], data["x"], data["y"])
    grown = post.grow_inducing(*grow)
    jgrown = jpost.grow_inducing(*(jnp.asarray(a) for a in grow))
    assert grown.num_inducing == jgrown.x_m.shape[0] == M_ODD + 5
    same(grown, base.grow_inducing(*grow), jgrown, "grow")
