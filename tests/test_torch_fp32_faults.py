"""The port's repairs of its fp32 faults (ROADMAP Queue C1-C3) on the CPU,
beside the JAX package on the same seeded numpy rows.

C1: an fp32 exact factor that fails raises `ops.linalg.FactorError`, a
FloatingPointError naming diag_reg, where the JAX Estimator raises a
FloatingPointError for its NaN factor; under tier='auto' the Estimator
refits on the Nystrom tier and says why; a relearn never re-routes; an
extend whose update fails keeps the old posterior, as in JAX.
C2: the DTC loss forms C = psi psi^T and the m x m stage in fp64 (fp32
inputs): within rel 5e-5 of the JAX fp32 loss (HIGHEST precision), within
rel 1e-4 of the port's fp64 loss at the same jitter (gradients 2e-4 of
their largest), and finite with lambda_min(C + rI) >= 0.5 r where fp32 C
is indefinite.
C3: an fp32 posterior with an input prescale evaluates the kernels its
variance reads in fp64 on the raw rows: no zero std on a toy packed-chunk
schema, where the JAX fp32 Estimator clamps the chunk-less rows' stds to
zero; stds within 2% of the fp64 Estimator's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.featurize.stats import ColumnStats as JaxColumnStats
from nngp_tpu.featurize.stats import TableStats as JaxTableStats
from nngp_tpu.gp import hyperopt as JH
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.featurize.stats import ColumnStats, TableStats
from nngp_tpu_torch.gp import NystromPosterior, fit_gp, select_diag_reg
from nngp_tpu_torch.gp import hyperopt as H
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from nngp_tpu_torch.ops.linalg import FactorError, cholesky_append_rows
from nngp_tpu_torch.serve import Estimator
from nngp_tpu_torch.serve import estimator as est_mod

TINY_RIDGE = 1e-9      # kappa ~ n / 1e-9 > 1 / eps_fp32 on near-duplicates


def _schema(table_stats, column_stats):
    """Two tables; ta carries a categorical column packed into one 64-bit
    chunk (raw features up to 2^63, prescaled by 2^64 in fp32)."""
    ta = table_stats("ta", (
        column_stats("id", "numerical", 0, 100),
        column_stats("x", "numerical", -10, 10),
        column_stats("c", "categorical", categories=tuple("abcdefgh")),
    ), chunk_size=64)
    tb = table_stats("tb", (
        column_stats("id", "numerical", 0, 100),
        column_stats("y", "numerical", 0, 1),
    ), chunk_size=64)
    return [ta, tb]


def _lines(rng, n, chunk_share=0.0, copies=1):
    """n labeled join lines (each repeated `copies` times); a share of them
    with a categorical predicate on ta.c."""
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        card = max(1, int(100 * (xu - xl)))
        pred = f"x,{xu:.3f},{xl:.3f}"
        if rng.uniform() < chunk_share:
            a, b = sorted(rng.choice(8, size=2, replace=False))
            pred += f"#c,{a},{b}"
            card = max(1, card // 4)
        out += [f"ta,tb@{pred}@@ta,tb,id@{card}"] * copies
    return out


def _query_dir(tmp_path, lines):
    qdir = tmp_path / "queries"
    qdir.mkdir()
    (qdir / "join_query_2.txt").write_text("\n".join(lines) + "\n")
    return str(qdir)


@pytest.fixture(scope="module")
def dup_dir(tmp_path_factory):
    """30 distinct lines, 8 copies each: the fp32 Gram at a 1e-9 ridge is
    not positive definite in fp32 (it is in fp64)."""
    return _query_dir(tmp_path_factory.mktemp("dup"),
                      _lines(np.random.default_rng(0), 30, copies=8))


def _cardless(lines):
    return [l.rsplit("@", 1)[0] for l in lines]


TEST_LINES = _cardless(_lines(np.random.default_rng(5), 12))


# ------------------------------------------------------------------- C1
@pytest.mark.parametrize("tier", [None, "exact"])
def test_a_failed_fp32_exact_factor_raises_like_jax(dup_dir, tier):
    """The JAX Estimator's fp32 factor of these rows is NaN and
    `_validate_fit` raises FloatingPointError; the port raises FactorError
    (a FloatingPointError) naming n, the failing order, the dtype and
    diag_reg. In fp64 both fit."""
    common = dict(verbose=False, diag_reg=TINY_RIDGE)
    with pytest.raises(FloatingPointError):
        JaxEstimator("toy", None, dup_dir, dtype=np.float32,
                     stats=_schema(JaxTableStats, JaxColumnStats), **common)
    with pytest.raises(FactorError) as err:
        Estimator("toy", None, dup_dir, dtype=np.float32, tier=tier,
                  stats=_schema(TableStats, ColumnStats), device="cpu",
                  **common)
    assert isinstance(err.value, FloatingPointError)
    msg = str(err.value)
    assert "diag_reg=1e-09" in msg and "n=240" in msg and "float32" in msg
    assert 1 <= err.value.order <= 240 and "Nystrom" in msg
    est = Estimator("toy", None, dup_dir, dtype=np.float64,
                    stats=_schema(TableStats, ColumnStats), device="cpu",
                    **common)
    assert np.all(np.isfinite(est.predict(TEST_LINES)[0]))


def _card_memory(monkeypatch):
    """tier='auto' routes as on an 80 GB H100 (test_exact_max_n_rule's
    stub): the exact tier up to ~126k fp32 rows."""
    class Props:
        total_memory = 85_029_158_912

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    real = est_mod.default_exact_max_n
    monkeypatch.setattr(est_mod, "default_exact_max_n",
                        lambda device, dtype, get="nngp":
                        real("cuda", dtype, get))


def test_tier_auto_refits_a_failed_fp32_exact_fit_on_the_nystrom_tier(
        dup_dir, monkeypatch, capsys):
    """tier='auto' chose the exact tier (240 rows, exact_max_n ~75k); its
    fp32 factor fails, so the fit goes to the Nystrom tier with
    auto_nystrom_m rows, printed and warned with the reason, and serves
    exactly what Estimator(tier='nystrom') serves."""
    _card_memory(monkeypatch)
    kw = dict(stats=_schema(TableStats, ColumnStats), dtype=np.float32,
              diag_reg=TINY_RIDGE, auto_nystrom_m=24, device="cpu")
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        est = Estimator("toy", None, dup_dir, tier="auto", **kw)
    out = capsys.readouterr().out
    cap = est_mod.default_exact_max_n("cuda", np.float32, "nngp")
    assert f"tier routing: n=240 -> exact; exact_max_n {cap}" in out
    line = next(l for l in out.splitlines() if "exact -> nystrom" in l)
    assert "m=24, moments=fp32" in line and "diag_reg=1e-09" in line
    assert any(str(w.message) == line and w.category is RuntimeWarning
               for w in warned)
    assert isinstance(est.posterior, NystromPosterior)
    assert est.nystrom_m == est.posterior.num_inducing == 24
    mean, std = est.predict(TEST_LINES)
    assert np.all(np.isfinite(mean)) and np.all(np.isfinite(std))
    assert np.all(std > 0)
    ny = Estimator("toy", None, dup_dir, tier="nystrom", verbose=False, **kw)
    np.testing.assert_array_equal(mean, ny.predict(TEST_LINES)[0])
    np.testing.assert_array_equal(std, ny.predict(TEST_LINES)[1])


def test_tier_auto_in_fp64_and_on_a_sound_set_does_not_reroute(
        dup_dir, tmp_path, monkeypatch):
    """The re-route is for fp32 only: in fp64 the same rows fit on the
    exact tier. A set whose fp32 factor succeeds stays exact too."""
    _card_memory(monkeypatch)
    kw = dict(stats=_schema(TableStats, ColumnStats), verbose=False,
              tier="auto", device="cpu")
    est = Estimator("toy", None, dup_dir, dtype=np.float64,
                    diag_reg=TINY_RIDGE, **kw)
    assert est.nystrom_m is None and not isinstance(est.posterior,
                                                    NystromPosterior)
    sound = _query_dir(tmp_path, _lines(np.random.default_rng(1), 60))
    est = Estimator("toy", None, sound, dtype=np.float32, **kw)
    assert est.nystrom_m is None and not isinstance(est.posterior,
                                                    NystromPosterior)


def test_a_reroute_after_an_exact_learn_relearns_against_the_dtc_evidence(
        tmp_path, monkeypatch):
    """learn_hyper resolved its objective to 'exact' for the exact tier;
    when that tier's factor fails, the hyperparameters are learned again
    against the DTC evidence of the Nystrom tier that serves. An explicit
    hyper_objective is kept."""
    _card_memory(monkeypatch)
    qdir = _query_dir(tmp_path, _lines(np.random.default_rng(2), 60))
    objectives = []
    real_learn = H.fit_kernel_hyperparams

    def learn(*args, **kw):
        objectives.append(kw["objective"])
        return real_learn(*args, **kw)

    def failing_fit(spec, x, y, **kw):
        raise FactorError("fit", 3, x.shape[0], torch.float32,
                          kw["diag_reg"])

    monkeypatch.setattr(H, "fit_kernel_hyperparams", learn)
    monkeypatch.setattr(est_mod, "fit_gp", failing_fit)
    common = dict(stats=_schema(TableStats, ColumnStats), verbose=False,
                  dtype=np.float32, tier="auto", auto_nystrom_m=16,
                  learn_hyper=True, hyper_steps=3, hyper_points=48,
                  device="cpu")
    with pytest.warns(RuntimeWarning, match="exact -> nystrom"):
        est = Estimator("toy", None, qdir, **common)
    assert objectives == ["exact", "dtc"]
    assert est.hyper_result.objective == "dtc" and est.nystrom_m == 16
    assert np.all(np.isfinite(est.predict(TEST_LINES)[0]))
    objectives.clear()
    with pytest.warns(RuntimeWarning, match="exact -> nystrom"):
        est = Estimator("toy", None, qdir, hyper_objective="exact", **common)
    assert objectives == ["exact"] and est.hyper_result.objective == "exact"


def test_relearn_never_reroutes_and_rolls_back(tmp_path, monkeypatch):
    """relearn_hyperparams on an exact-tier server whose refit factor
    fails raises the FloatingPointError and keeps the tier, the spec, the
    ridge and the posterior."""
    _card_memory(monkeypatch)
    qdir = _query_dir(tmp_path, _lines(np.random.default_rng(3), 60))
    est = Estimator("toy", None, qdir, stats=_schema(TableStats, ColumnStats),
                    verbose=False, dtype=np.float32, tier="auto",
                    device="cpu")
    before = (est.spec, est.diag_reg, est.posterior)
    base = est.predict(TEST_LINES)

    def failing_fit(spec, x, y, **kw):
        raise FactorError("fit", 5, x.shape[0], torch.float32,
                          kw["diag_reg"])

    monkeypatch.setattr(est_mod, "fit_gp", failing_fit)
    with pytest.raises(FloatingPointError, match="diag_reg"):
        est.relearn_hyperparams(steps=2, max_points=48, verbose=False)
    assert (est.spec, est.diag_reg, est.posterior) == before
    assert est.nystrom_m is None
    np.testing.assert_array_equal(est.predict(TEST_LINES)[0], base[0])


def test_an_extend_whose_update_fails_keeps_the_old_posterior_like_jax(
        tmp_path):
    """Lines already in the train set, appended again at a 1e-9 ridge:
    the Schur complement of the fp32 append is not positive definite. The
    JAX Estimator's NaN factor fails validation and the port raises
    FactorError naming diag_reg; both keep serving the old posterior."""
    rng = np.random.default_rng(4)
    train = _lines(rng, 20)
    qdir = _query_dir(tmp_path, train)
    kw = dict(verbose=False, dtype=np.float32, diag_reg=TINY_RIDGE)
    jest = JaxEstimator("toy", None, qdir,
                        stats=_schema(JaxTableStats, JaxColumnStats), **kw)
    est = Estimator("toy", None, qdir, stats=_schema(TableStats, ColumnStats),
                    device="cpu", **kw)
    again = train * 4
    for e, err in ((jest, FloatingPointError), (est, FactorError)):
        before = e.posterior
        base = e.predict(TEST_LINES)
        with pytest.raises(err) as info:
            e.extend_with_lines(again)
        assert e.posterior is before
        np.testing.assert_array_equal(e.predict(TEST_LINES)[0], base[0])
    assert info.value.op == "extend" and info.value.diag_reg == TINY_RIDGE
    assert "diag_reg=1e-09" in str(info.value)


def test_cholesky_append_rows_names_the_failing_order():
    """The append's failure counts its order in the appended Gram."""
    l11 = torch.eye(3, dtype=torch.float64)
    k21 = torch.zeros((2, 3), dtype=torch.float64)
    k22 = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=torch.float64)
    with pytest.raises(FactorError) as err:
        cholesky_append_rows(l11, k21, k22)
    assert (err.value.op, err.value.order, err.value.n) == ("extend", 5, 5)
    assert err.value.diag_reg is None and "diag_reg=" not in str(err.value)


def test_fit_gp_and_select_diag_reg_on_a_failing_fp32_gram():
    """fit_gp raises FactorError (the JAX fit returns a NaN factor);
    select_diag_reg scores the failing candidate NaN and keeps the one
    that factors."""
    rng = np.random.default_rng(6)
    x = np.repeat(rng.uniform(0, 1000, (12, 6)), 10, axis=0).astype(
        np.float32)
    y = rng.uniform(0, 20, (120, 1)).astype(np.float32)
    spec = reference_kernel()
    with pytest.raises(FactorError, match="fit"):
        fit_gp(spec, x, y, diag_reg=TINY_RIDGE, device="cpu")
    post, scores = select_diag_reg(spec, x, y, candidates=(TINY_RIDGE, 1e-2),
                                   device="cpu")
    assert np.isnan(scores[TINY_RIDGE]) and np.isfinite(scores[1e-2])
    assert post.diag_reg == 1e-2


# ------------------------------------------------------------------- C2
THETA = {"log_w0": [0.1], "log_w": [-0.2], "log_b": [np.log(0.1)],
         "log_reg": [np.log(1e-3)]}


def _port_dtc(x, y, m, dtype, theta=THETA, **kw):
    """The port's DTC loss and its gradient at fp32's dual clamp."""
    th = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
          for k, v in theta.items()}
    val = H._nll_dtc(th, torch.tensor(x, dtype=dtype),
                     torch.tensor(y, dtype=dtype), m, 1, "relu", 512, "nngp",
                     H._grad_safe_duals(1e-6), **kw)
    grads = torch.autograd.grad(val.sum(), list(th.values()))
    return float(val[0].detach()), np.array([float(g[0]) for g in grads])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp32_dtc_loss_matches_jax_fp32_and_the_port_fp64(seed):
    """On fp32 inputs: rel 5e-5 of JAX's fp32 loss (HIGHEST), rel 1e-4 of
    the port's fp64 loss at the same K_mm jitter, gradients within 2e-4 of
    the fp64 gradient's largest entry; the loss comes back in fp32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (600, 6))
    y = np.sin(x.sum(1, keepdims=True) * 3) + 2.0
    v32, g32 = _port_dtc(x, y, 32, torch.float32, mm_jitter_rel=1e-4)
    v64, g64 = _port_dtc(x, y, 32, torch.float64, mm_jitter_rel=1e-4)
    with jax.default_matmul_precision("highest"):
        jval = float(JH._nll_dtc(
            {k: jnp.asarray(v[0], jnp.float32) for k, v in THETA.items()},
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), 32, 1,
            "relu", 512, "nngp", JH._grad_safe_duals(1e-6),
            mm_jitter_rel=1e-4))
    assert v32 == pytest.approx(jval, rel=5e-5)
    assert v32 == pytest.approx(v64, rel=1e-4)
    assert np.max(np.abs(g32 - g64)) <= 2e-4 * np.max(np.abs(g64))
    th = {k: torch.tensor(v, dtype=torch.float32) for k, v in THETA.items()}
    assert H._nll_dtc(th, torch.tensor(x, dtype=torch.float32),
                      torch.tensor(y, dtype=torch.float32), 32, 1, "relu",
                      512, "nngp", H._grad_safe_duals(1e-6)).dtype \
        == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_fp64_c_keeps_its_margin_where_fp32_c_is_indefinite(seed,
                                                            monkeypatch):
    """Duplicated inducing pairs and a 1e-9 ridge: kappa(C + rI) ~ 1e13 >
    1 / eps_fp32. C formed in fp32 (as before this repair, and as JAX
    forms it) leaves C + rI indefinite and the loss NaN; formed in fp64,
    its smallest eigenvalue stays >= 0.5 r and the loss is finite, within
    1% of the fp64 loss."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3000, 8))
    x[1:64:2] = x[0:64:2]
    y = np.sin(x.sum(1, keepdims=True) * 3) + 2.0
    theta = dict(THETA, log_w0=[0.0], log_w=[0.0], log_reg=[np.log(1e-9)])
    margins = []
    real = H._c_factor

    def factor(c, r):
        r0 = float(r[0].detach())
        a = c[0].detach().double() + r0 * torch.eye(c.shape[-1],
                                                    dtype=torch.float64)
        margins.append(float(torch.linalg.eigvalsh(a)[0]) / r0)
        return real(c, r)

    monkeypatch.setattr(H, "_c_factor", factor)
    val, grad = _port_dtc(x, y, 64, torch.float32, theta)
    assert np.isfinite(val) and np.all(np.isfinite(grad))
    assert margins[0] >= 0.5
    v64, _ = _port_dtc(x, y, 64, torch.float64, theta, mm_jitter_rel=1e-4)
    assert val == pytest.approx(v64, rel=1e-2)
    monkeypatch.setattr(H, "_c_moments",
                        lambda psi, ym: (psi @ psi.mT, psi @ ym))
    val32c, _ = _port_dtc(x, y, 64, torch.float32, theta)
    assert np.isnan(val32c) and margins[-1] < 0


# ------------------------------------------------------------------- C3
@pytest.fixture(scope="module")
def chunk_dir(tmp_path_factory):
    """120 lines, 60% of them with a packed-chunk predicate (raw features
    ~1e18), the rest with none (|x| <= 1000)."""
    return _query_dir(tmp_path_factory.mktemp("chunk"),
                      _lines(np.random.default_rng(7), 120, chunk_share=0.6))


def test_fp32_std_on_a_packed_chunk_encoding_has_no_zeros(chunk_dir):
    """The fp32 posterior prescales by 2^64; its variance's kernels run in
    fp64 on the raw rows. No std is zero, and each is within 2% of the
    fp64 Estimator's (the chunk-less rows' to 1e-6); the JAX fp32
    Estimator clamps the chunk-less rows' stds to zero. The means keep the
    prescaled fp32 cross Gram, as JAX's."""
    lines = _cardless(_lines(np.random.default_rng(8), 40, chunk_share=0.6))
    chunkless = np.array(["#c," not in l for l in lines])
    assert 5 < chunkless.sum() < 35
    est32 = Estimator("toy", None, chunk_dir,
                      stats=_schema(TableStats, ColumnStats), verbose=False,
                      dtype=np.float32, device="cpu")
    est64 = Estimator("toy", None, chunk_dir,
                      stats=_schema(TableStats, ColumnStats), verbose=False,
                      dtype=np.float64, device="cpu")
    jest = JaxEstimator("toy", None, chunk_dir,
                        stats=_schema(JaxTableStats, JaxColumnStats),
                        verbose=False, dtype=np.float32)
    assert est32.posterior.input_scale == 2.0 ** 64
    mean, std = est32.predict(lines)
    mean64, std64 = est64.predict(lines)
    jmean, jstd = jest.predict(lines)
    assert np.all(std > 0) and np.all(np.isfinite(std))
    assert np.all(jstd[chunkless] == 0.0) and np.all(jstd[~chunkless] > 0)
    np.testing.assert_allclose(std, std64, rtol=2e-2)
    np.testing.assert_allclose(std[chunkless], std64[chunkless], rtol=1e-6)
    np.testing.assert_allclose(mean, mean64, atol=0.1)
    np.testing.assert_allclose(mean, jmean, atol=0.1)


@pytest.mark.parametrize("dtype,chunk_norm", [(np.float32, True),
                                              (np.float64, False)],
                         ids=["fp32-chunk_norm", "fp64-raw"])
def test_posteriors_without_an_fp32_prescale_keep_their_variance(
        chunk_dir, dtype, chunk_norm):
    """fp64 posteriors, and fp32 ones without a prescale (chunk_norm puts
    the chunks on [0, 1000]), read the cross Gram of their own dtype and
    units: predict_mean_std equals the variance written out with
    gram_cross, diag_eval and the triangular solve, bit for bit."""
    from nngp_tpu_torch.models.kernel_spec import diag_eval
    from nngp_tpu_torch.ops.gram_cuda import gram_cross

    est = Estimator("toy", None, chunk_dir,
                    stats=_schema(TableStats, ColumnStats), verbose=False,
                    dtype=dtype, chunk_norm=chunk_norm, device="cpu")
    post = est.posterior
    assert post.input_scale == 1.0 and not post._raw64
    x = torch.as_tensor(est.encode_lines(TEST_LINES))
    cross = gram_cross(post.spec, x, post.x_train, "nngp")
    v = torch.linalg.solve_triangular(post.l, cross.mT, upper=False)
    var = diag_eval(post.spec.layers, x, "nngp") - torch.sum(v * v, dim=0)
    mean, std = post.predict_mean_std(x)
    assert torch.equal(mean, cross @ post.alpha)
    assert torch.equal(std, torch.sqrt(torch.clamp_min(var, 0.0)))


def test_the_distributed_tier_reads_the_same_raw_fp64_variance(chunk_dir):
    """The row-sharded posterior at world size 1 shares the repair: no
    zero std; the chunk-less rows' stds within 1e-6 of the exact tier's on
    the same rows, the others within 3% (the block-cyclic fp32 factor sums
    in another order, and those stds carry fp32 noise: 1% from fp64's)."""
    from nngp_tpu_torch.parallel import make_mesh

    lines = _cardless(_lines(np.random.default_rng(9), 40, chunk_share=0.6))
    kw = dict(stats=_schema(TableStats, ColumnStats), verbose=False,
              dtype=np.float32, device="cpu")
    dist_est = Estimator("toy", None, chunk_dir,
                         mesh=make_mesh(1, device="cpu"), **kw)
    exact = Estimator("toy", None, chunk_dir, **kw)
    assert type(dist_est.posterior).__name__ == "DistributedPosterior"
    chunkless = np.array(["#c," not in l for l in lines])
    std, want = dist_est.predict(lines)[1], exact.predict(lines)[1]
    assert np.all(std > 0) and 5 < chunkless.sum() < 35
    np.testing.assert_allclose(std[chunkless], want[chunkless], rtol=1e-6)
    np.testing.assert_allclose(std, want, rtol=3e-2)


@pytest.mark.parametrize("transpose", [False, True])
def test_the_block_substitution_of_a_wide_rhs_is_the_fp64_solve(
        monkeypatch, transpose):
    """An fp64 right-hand side against an fp32 factor, in blocks of 7 of
    30 rows: the fp64 triangular solve against the factor's fp64 copy
    (rel 1e-12); and K @ w by row blocks, the fp64 product."""
    from nngp_tpu_torch.gp import posterior as P

    monkeypatch.setattr(P, "_WIDE_BLOCK", 7)
    rng = np.random.default_rng(10)
    a = rng.standard_normal((30, 30))
    l32 = torch.linalg.cholesky(torch.tensor(a @ a.T + 30 * np.eye(30),
                                             dtype=torch.float32))
    b = torch.tensor(rng.standard_normal((30, 4)))
    got = P._tri_solve(l32, b, transpose=transpose)
    want = torch.linalg.solve_triangular(
        l32.double().mT if transpose else l32.double(), b, upper=transpose)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    np.testing.assert_allclose(P._mm_wide(l32, b).numpy(),
                               (l32.double() @ b).numpy(), rtol=1e-12)
