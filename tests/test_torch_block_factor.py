"""The port's column-block exact tier (`ops.linalg.BlockLowerTriangular`,
`fused_panel_cholesky`, the block solves and append, `ops.gram`'s panel
Grams, `fit_gp` above the layout switch, its Estimator checkpoints and
`convert.py`) against the JAX package's, fp64 on the CPU.

Both packages' switches are forced to small n: the port's through
`gp.posterior._BLOCK_LAYOUT_MIN_N` (and `_BLOCK_PANEL` for several
blocks), the JAX package's through `_BLOCK_LAYOUT_MIN_N` and
`_FUSED_FIT_MIN_N`, as tests/test_posterior.py does.

Tolerances: factors, solves and appends of the same matrix 1e-9 (rtol and
atol); the port's block posterior against its own dense one 1e-10 (the
same Gram, factored in two orders); against the JAX block posterior rtol
1e-7 on the mean and 1e-6 on the variance, the covariance and the
evidence, as tests/test_torch_posterior.py holds the dense one (JAX's
`panel_symm_matmul` panels carry the computed NNGP diagonal, the port's
the exact one, which moves the NTK covariance by ~1e-8); the fp32
prescaled block posterior against a dense one holding the same factor
1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nngp_tpu.gp.posterior as JP
from nngp_tpu.ops import gram as jgram
from nngp_tpu.ops import linalg as JL
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.convert import posterior_from_numpy, posterior_to_numpy
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.gp import posterior as P
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from nngp_tpu_torch.ops import (BlockLowerTriangular, FactorError,
                                block_cholesky_append_rows,
                                block_tri_solve_lower,
                                block_tri_solve_lower_t, blocked_cholesky,
                                blocked_tri_solve_lower,
                                blocked_tri_solve_lower_t,
                                fused_panel_cholesky, panel_gram,
                                panel_symm_matmul)
from nngp_tpu_torch.ops.gram_cuda import gram_sym
from nngp_tpu_torch.serve import Estimator
from nngp_tpu_torch.serve import estimator as est_mod
from tests.test_active_serve import _toy_schema_files
from tests.test_torch_common import jax_spec, n, rows, t

TOL = dict(rtol=1e-9, atol=1e-9)
LINES = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id",
         "ta,tb@x,1.0,-2.0@@ta,tb,id", "ta,tb@x,9.5,0.5@@ta,tb,id"]
FEEDBACK = ["ta,tb@x,3.0,1.0@@ta,tb,id@2000",
            "ta,tb@x,-4.0,-9.0@@ta,tb,id@900",
            "ta,tb@x,8.0,2.5@@ta,tb,id@5400"]


def _spd(size, seed):
    a = np.random.default_rng(seed).standard_normal((size, size))
    return a @ a.T + size * np.eye(size)


def _writer(k):
    def panel_fn(s, e, out):
        out.copy_(t(k[s:, s:e]))
    return panel_fn


@pytest.fixture
def forced(monkeypatch):
    """Both packages' block layout from 64 rows; the port's blocks 64
    columns wide."""
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 64)
    monkeypatch.setattr(P, "_BLOCK_PANEL", 64)
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)
    monkeypatch.setattr(JP, "_BLOCK_LAYOUT_MIN_N", 64)


# ------------------------------------------------------------ ops.linalg
@pytest.mark.parametrize("layout", ["inplace", "columns", "blocks"])
def test_fused_panel_cholesky_matches_jax_and_numpy(layout):
    size = 500
    k = _spd(size, 11)
    got = fused_panel_cholesky(_writer(k), size, torch.float64,
                               block_size=128, layout=layout)
    want = JL.fused_panel_cholesky(lambda s, e: jnp.asarray(k[s:, s:e]),
                                   size, jnp.float64, block_size=128,
                                   layout=layout)
    if layout == "blocks":
        assert isinstance(got, BlockLowerTriangular)
        assert got.shape == (size, size) and got.dtype == torch.float64
        assert got.starts == tuple(want.starts) == (0, 128, 256, 384, 500)
        for g, w in zip(got.blocks, want.blocks):
            np.testing.assert_allclose(n(g), n(w), **TOL)
        np.testing.assert_allclose(n(got.diagonal()), n(want.diagonal()),
                                   **TOL)
        got, want = got.to_dense(), want.to_dense()
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got), np.linalg.cholesky(k), **TOL)


def test_fused_panel_cholesky_rejects_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        fused_panel_cholesky(_writer(_spd(8, 0)), 8, torch.float64,
                             layout="rows")


def test_blocked_cholesky_ignores_garbage_upper_triangle():
    """Only the lower triangle is read: NaN above it does not reach the
    factor (tests/test_posterior.py's case, against JAX's and numpy's)."""
    size = 300
    k = _spd(size, 13)
    dirty = np.tril(k) + np.triu(np.full((size, size), np.nan), 1)
    got = blocked_cholesky(t(dirty), block_size=128)
    want = JL.blocked_cholesky(jnp.asarray(dirty), block_size=128)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got), np.linalg.cholesky(k), **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_blocked_tri_solves_match_jax(transpose):
    size, r = 450, 7
    l = np.linalg.cholesky(_spd(size, 3))
    rhs = np.random.default_rng(4).standard_normal((size, r))
    ours = blocked_tri_solve_lower_t if transpose else blocked_tri_solve_lower
    theirs = (JL.blocked_tri_solve_lower_t if transpose
              else JL.blocked_tri_solve_lower)
    got = ours(t(l), t(rhs), block_size=128)
    np.testing.assert_allclose(
        n(got), n(theirs(jnp.asarray(l), jnp.asarray(rhs), block_size=128)),
        **TOL)
    np.testing.assert_allclose(n(got), np.linalg.solve(l.T if transpose
                                                      else l, rhs), **TOL)


def test_block_factor_solves_and_append_match_jax():
    """tests/test_posterior.py's case: the block factor, both solves and
    the append of m rows, each against the JAX function and numpy."""
    size, m, r = 500, 70, 9
    k = _spd(size + m, 14)
    bf = fused_panel_cholesky(_writer(k[:size, :size]), size, torch.float64,
                              block_size=128, layout="blocks")
    jbf = JL.fused_panel_cholesky(lambda s, e: jnp.asarray(k[s:size, s:e]),
                                  size, jnp.float64, block_size=128,
                                  layout="blocks")
    rhs = np.random.default_rng(15).standard_normal((size, r))
    want = np.linalg.cholesky(k[:size, :size])
    for ours, theirs, dense in (
            (block_tri_solve_lower, JL.block_tri_solve_lower, want),
            (block_tri_solve_lower_t, JL.block_tri_solve_lower_t, want.T)):
        got = ours(bf, t(rhs))
        np.testing.assert_allclose(n(got), n(theirs(jbf, jnp.asarray(rhs))),
                                   **TOL)
        np.testing.assert_allclose(n(got), np.linalg.solve(dense, rhs),
                                   **TOL)
    ext = block_cholesky_append_rows(bf, t(k[size:, :size]),
                                     t(k[size:, size:]))
    jext = JL.block_cholesky_append_rows(jbf, jnp.asarray(k[size:, :size]),
                                         jnp.asarray(k[size:, size:]))
    assert ext.shape == (size + m, size + m)
    assert ext.starts == tuple(jext.starts)
    for g, w in zip(ext.blocks, jext.blocks):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    np.testing.assert_allclose(n(ext.to_dense()), np.linalg.cholesky(k),
                               **TOL)
    assert len(bf.blocks) == 4       # the factor appended to is unchanged


def test_block_solves_of_a_wider_right_hand_side():
    """An fp64 right-hand side against fp32 blocks is solved in fp64, the
    blocks converted a slice at a time: what the fp64 solve against the
    blocks converted whole gives (1e-12)."""
    size = 300
    k = _spd(size, 16)
    bf = fused_panel_cholesky(_writer(k.astype(np.float32)), size,
                              torch.float32, block_size=96, layout="blocks")
    wide = BlockLowerTriangular([b.double() for b in bf.blocks], bf.starts,
                                size)
    rhs = t(np.random.default_rng(17).standard_normal((size, 5)))
    for solve in (block_tri_solve_lower, block_tri_solve_lower_t):
        got = solve(bf, rhs)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(n(got), n(solve(wide, rhs)), rtol=1e-12,
                                   atol=1e-12)


def test_block_factor_shapes_are_checked():
    with pytest.raises(ValueError, match="do not tile"):
        BlockLowerTriangular([torch.zeros(5, 2), torch.zeros(4, 3)],
                             (0, 2, 5), 5)
    bf = fused_panel_cholesky(_writer(_spd(10, 1)), 10, torch.float64,
                              block_size=4, layout="blocks")
    with pytest.raises(ValueError, match="append"):
        block_cholesky_append_rows(bf, torch.zeros(2, 9), torch.eye(2))


def test_a_failed_block_factor_names_its_global_order():
    """A diagonal square that is not positive definite raises FactorError
    with s + its info: here row 150 (order 151) of a 300-row matrix, in
    the second 128-column block; numpy's factor fails on it too."""
    k = _spd(300, 18)
    k[150, 150] = -1.0
    for layout in ("inplace", "blocks"):
        with pytest.raises(FactorError) as err:
            fused_panel_cholesky(_writer(k), 300, torch.float64,
                                 block_size=128, layout=layout)
        assert err.value.order == 151 and err.value.op == "fit"
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.cholesky(k)


# -------------------------------------------------------------- ops.gram
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_panel_symm_matmul_and_panel_gram_match_jax(get):
    spec = reference_kernel()
    x = rows(300, seed=5)
    w = np.random.default_rng(6).standard_normal((300, 4))
    got = panel_symm_matmul(spec, t(x), t(w), get, block_size=128)
    want = jgram.panel_symm_matmul(jax_spec(spec).layers, jnp.asarray(x),
                                   jnp.asarray(w), get, block_size=128)
    scale = float(np.max(np.abs(n(want))))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-7, atol=1e-7 * scale)
    full = gram_sym(spec, t(x), get)
    np.testing.assert_allclose(n(got), n(full @ t(w)), rtol=1e-10,
                               atol=1e-10 * scale)
    k = panel_gram(spec, t(x), get, block_size=128)
    np.testing.assert_allclose(n(k), n(full), rtol=1e-12, atol=0)
    jk = jgram.panel_gram(jax_spec(spec).layers, jnp.asarray(x), get,
                          block_size=128)
    np.testing.assert_allclose(n(k), n(jk), rtol=1e-7,
                               atol=1e-7 * float(np.max(n(jk))))


def test_panel_symm_matmul_of_a_wider_w():
    spec = reference_kernel()
    x = rows(200, seed=7).astype(np.float32)
    w = t(np.random.default_rng(8).standard_normal((200, 3)))
    got = panel_symm_matmul(spec, t(x), w, block_size=64)
    assert got.dtype == torch.float64
    want = gram_sym(spec, t(x)).double() @ w
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12,
                               atol=1e-12 * float(torch.max(torch.abs(want))))


# ------------------------------------------------------------ gp.posterior
def _data(n_train=300, n_test=17, n_new=12, seed=20):
    rng = np.random.default_rng(seed)
    x = rows(n_train, seed=seed)
    y = rng.uniform(0.0, 16.0, (n_train, 1))
    xt = rows(n_test, seed=seed + 1, special=False)
    xn = rows(n_new, seed=seed + 2, special=False)
    return x, y, xt, xn, rng.uniform(0.0, 16.0, (n_new, 1))


def _close(got, want, rtol):
    want = n(want)
    np.testing.assert_allclose(n(got), want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fit_gp_block_layout_matches_jax_and_dense(get, forced, monkeypatch):
    spec = reference_kernel()
    x, y, xt, xn, yn = _data()
    post = fit_gp(spec, t(x), t(y), get=get)
    assert isinstance(post.l, BlockLowerTriangular)
    assert post.l.starts == (0, 64, 128, 192, 256, 300)
    assert post.k_tt_nngp is None
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      get=get)
    assert isinstance(jpost.l, JL.BlockLowerTriangular)
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 10 ** 9)
    dense = fit_gp(spec, t(x), t(y), get=get)
    assert isinstance(dense.l, torch.Tensor)
    assert (dense.k_tt_nngp is None) == (get == "nngp")

    np.testing.assert_allclose(n(post.alpha), n(jpost.alpha), rtol=1e-7)
    _close(post.alpha, dense.alpha, 1e-10)
    for p_ext in (False, True):
        if p_ext:
            post, dense = post.extend(xn, yn), dense.extend(xn, yn)
            jpost = jpost.extend(jnp.asarray(xn), jnp.asarray(yn))
            assert isinstance(post.l, BlockLowerTriangular)
            assert post.l.starts[-2:] == (300, 312)
            assert post.k_tt_nngp is None   # a lazy K_tt stays lazy
        for cov in ("diag", True):
            mean, var = post.predict(xt, compute_cov=cov)
            jmean, jvar = jpost.predict(jnp.asarray(xt), compute_cov=cov)
            dmean, dvar = dense.predict(xt, compute_cov=cov)
            _close(mean, jmean, 1e-7)
            _close(var, jvar, 1e-6)
            _close(mean, dmean, 1e-10)
            _close(var, dvar, 1e-10)
        ev = post.log_marginal_likelihood()
        np.testing.assert_allclose(ev, float(jpost.log_marginal_likelihood()),
                                   rtol=1e-6)
        np.testing.assert_allclose(ev, dense.log_marginal_likelihood(),
                                   rtol=1e-10)


def test_fp32_prescaled_block_posterior_matches_dense(forced):
    """fp32 with an input prescale: the variance runs in fp64 against the
    fp32 blocks (C3's wide solve), block by block. It serves what a dense
    posterior holding the same factor serves (1e-6: fp64 solves in two
    blockings, rounded to fp32)."""
    spec = reference_kernel()
    x, y, xt, _, _ = _data(seed=30)
    x = (x * 2.0 ** 30).astype(np.float32)
    xt = (xt * 2.0 ** 30).astype(np.float32)
    post = fit_gp(spec, x, y.astype(np.float32), device="cpu")
    assert post.input_scale > 1.0 and isinstance(post.l, BlockLowerTriangular)
    dense = dataclasses.replace(post, l=post.l.to_dense())
    for cov in ("diag", True):
        for got, want in zip(post.predict(xt, cov), dense.predict(xt, cov)):
            assert got.dtype == torch.float32
            assert bool(torch.all(torch.isfinite(got)))
            _close(got, want, 1e-6)


def test_a_failed_block_fit_names_its_order_and_diag_reg(forced, monkeypatch):
    """Row 90 duplicates row 5, and a small negative absolute ridge makes
    its Schur complement negative: the block fit raises FactorError at
    order 91, in its second block, naming diag_reg, as the dense fit does;
    the JAX block fit returns a NaN factor there."""
    spec = reference_kernel()
    _, y, _, _, _ = _data(seed=40)
    x = rows(300, seed=40, special=False)
    x[90] = x[5]
    kw = dict(diag_reg=-1e-6, diag_reg_absolute_scale=True)
    with pytest.raises(FactorError) as err:
        fit_gp(spec, t(x), t(y), **kw)
    assert err.value.order == 91 and err.value.n == 300
    assert "diag_reg=-1e-06" in str(err.value)
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y), **kw)
    assert not np.all(np.isfinite(n(jpost.l.diagonal())))
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 10 ** 9)
    with pytest.raises(FactorError) as dense_err:
        fit_gp(spec, t(x), t(y), **kw)
    assert dense_err.value.order == 91


def test_pad_to_is_refused_above_the_switch(forced, monkeypatch):
    """Padding is a dense-layout feature: pad_to is capped below the switch,
    as the JAX package refuses pad_to >= its _BLOCK_LAYOUT_MIN_N."""
    spec = reference_kernel()
    x, y, _, _, _ = _data(n_train=40)
    assert fit_gp(spec, t(x), t(y), pad_to=63).num_padded == 63
    with pytest.raises(ValueError, match="dense factor layout"):
        fit_gp(spec, t(x), t(y), pad_to=64)
    with pytest.raises(ValueError, match="column-block"):
        JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y), pad_to=64)
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", None)
    with pytest.raises(ValueError, match="27999"):
        fit_gp(spec, t(x), t(y), pad_to=P.BLOCK_LAYOUT_MIN_N_CPU)


# ------------------------------------------------ serve/estimator, convert
@pytest.fixture
def toy(tmp_path):
    return _toy_schema_files(tmp_path)


def _estimators(toy, kernel_type):
    stats, qdir = toy
    kw = dict(stats=stats, verbose=False, dtype=np.float64,
              kernel_type=kernel_type)
    return (JaxEstimator("toy", None, qdir, **kw),
            Estimator("toy", None, qdir, device="cpu", **kw))


def _keys(ckpt):
    with open(ckpt / "meta.json") as f:
        meta = json.load(f)
    with np.load(ckpt / "posterior.npz") as z:
        return meta, set(z.files)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_block_checkpoints_cross_both_ways(toy, writer, tmp_path, forced,
                                           monkeypatch):
    """The toy schema's 60 rows, fp64, both switches forced (JAX's rule
    gives one 512-column block, the port's blocks are 16 wide): a block
    checkpoint carries `l_block_starts` / `l_block_{i}` and no dense `l`;
    the other package restores it as blocks and predicts what the writer
    predicts (1e-9), and extends it as the writer does. A restore in the
    writing package predicts bit for bit."""
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 16)
    monkeypatch.setattr(P, "_BLOCK_PANEL", 16)
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 16)
    monkeypatch.setattr(JP, "_BLOCK_LAYOUT_MIN_N", 16)
    jest, est = _estimators(toy, "nngp")
    assert isinstance(est.posterior.l, BlockLowerTriangular)
    ckpt = tmp_path / "ck"
    (jest if writer == "jax" else est).save(str(ckpt))
    meta, files = _keys(ckpt)
    starts = meta["l_block_starts"]
    assert "l" not in files
    assert {f"l_block_{i}" for i in range(len(starts) - 1)} <= files
    if writer == "jax":
        assert starts == [0, 60]
        back = Estimator.restore(str(ckpt), device="cpu")
        assert isinstance(back.posterior.l, BlockLowerTriangular)
        other = jest
    else:
        assert starts == [0, 16, 32, 48, 60]
        back = JaxEstimator.restore(str(ckpt))
        assert isinstance(back.posterior.l, JL.BlockLowerTriangular)
        other = est
        same = Estimator.restore(str(ckpt), device="cpu")
        for g, w in zip(same.predict(LINES), est.predict(LINES)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(back.predict(LINES), other.predict(LINES)):
        _close(g, w, 1e-9)
    assert back.extend_with_lines(FEEDBACK) == 3
    assert other.extend_with_lines(FEEDBACK) == 3
    assert back.posterior.num_train == 63
    for g, w in zip(back.predict(LINES), other.predict(LINES)):
        _close(g, w, 1e-9)


def test_a_block_checkpoint_below_the_switch_is_assembled(toy, tmp_path,
                                                          forced, monkeypatch):
    """Restored where `fit_gp` would factor its rows densely, a block
    checkpoint's factor is assembled into one dense tensor."""
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", 16)
    monkeypatch.setattr(P, "_BLOCK_PANEL", 16)
    _, est = _estimators(toy, "ntk")
    assert est.posterior.k_tt_nngp is None
    est.save(str(tmp_path / "ck"))
    monkeypatch.setattr(P, "_BLOCK_LAYOUT_MIN_N", None)
    back = Estimator.restore(str(tmp_path / "ck"), device="cpu")
    assert isinstance(back.posterior.l, torch.Tensor)
    np.testing.assert_allclose(n(back.posterior.l),
                               n(est.posterior.l.to_dense()), rtol=0, atol=0)
    for g, w in zip(back.predict(LINES[:1]), est.predict(LINES[:1])):
        _close(g, w, 1e-10)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_convert_carries_a_jax_block_posterior(get, forced):
    spec = reference_kernel()
    x, y, xt, _, _ = _data(n_train=600, seed=50)
    jpost = JP.fit_gp(jax_spec(spec), jnp.asarray(x), jnp.asarray(y),
                      get=get)
    assert len(jpost.l.blocks) == 2
    state = {"x_train": np.asarray(jpost.x_train),
             "y_train": np.asarray(jpost.y_train), "l": jpost.l,
             "alpha": np.asarray(jpost.alpha), "reg": np.asarray(jpost.reg),
             "k_tt_nngp": None, "diag_reg": jpost.diag_reg,
             "input_scale": jpost.input_scale, "n_real": None}
    post = posterior_from_numpy(state, spec, get, "cpu")
    assert isinstance(post.l, BlockLowerTriangular)
    assert post.l.starts == (0, 512, 600)
    for got, want in zip(post.predict(xt, "diag"),
                         jpost.predict(jnp.asarray(xt), "diag")):
        _close(got, want, 1e-7)
    back = posterior_to_numpy(post)
    assert isinstance(back["l"], BlockLowerTriangular)
    assert isinstance(back["l"].blocks[0], np.ndarray)
    jl = JL.BlockLowerTriangular([jnp.asarray(b) for b in back["l"].blocks],
                                 back["l"].starts, back["l"].n)
    jback = JP.GPPosterior(
        x_train=jnp.asarray(back["x_train"]),
        y_train=jnp.asarray(back["y_train"]), l=jl,
        alpha=jnp.asarray(back["alpha"]), reg=jnp.asarray(back["reg"]),
        k_tt_nngp=None, spec=jax_spec(spec), get=get)
    for got, want in zip(jback.predict(jnp.asarray(xt), "diag"),
                         jpost.predict(jnp.asarray(xt), "diag")):
        np.testing.assert_array_equal(n(got), n(want))


def test_route_tier_keeps_exact_between_the_two_caps(toy, capsys,
                                                     monkeypatch):
    """tier='auto' keeps the exact tier up to default_exact_max_n, which
    now lies above the dense cap: 60 rows between a dense cap of 40 and an
    exact cap of 100 fit exactly, as column blocks; above 100 they go to
    the Nystrom tier."""
    stats, qdir = toy
    monkeypatch.setattr(P, "dense_exact_max_n", lambda *a, **k: 40)
    monkeypatch.setattr(P, "_BLOCK_PANEL", 16)
    kw = dict(stats=stats, dtype=np.float64, device="cpu", tier="auto")
    monkeypatch.setattr(est_mod, "default_exact_max_n",
                        lambda device, dtype, get="nngp": 100)
    est = Estimator("toy", None, qdir, **kw)
    assert "tier routing: n=60 -> exact; exact_max_n 100" in \
        capsys.readouterr().out
    assert isinstance(est.posterior.l, BlockLowerTriangular)
    assert est.nystrom_m is None
    monkeypatch.setattr(est_mod, "default_exact_max_n",
                        lambda device, dtype, get="nngp": 50)
    est = Estimator("toy", None, qdir, **kw)
    assert "n=60 -> nystrom" in capsys.readouterr().out
    assert est.nystrom_m == 60
