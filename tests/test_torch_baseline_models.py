"""Every finite-width baseline module of the port (`models/baselines.py`,
`models/mscn.py`, `models/tree_lstm.py`) against its flax original: the
flax parameters are carried across by `nngp_tpu_torch.convert` (with the
zero biases perturbed, so that a misplaced bias shows) and the same seeded
numpy inputs go through both forwards. Tolerances: 1e-6 absolute in fp32,
1e-12 in fp64, on outputs of order 1.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.models import baselines_flax as JB
from nngp_tpu.models import mscn as JM
from nngp_tpu.models import tree_lstm as JT
from nngp_tpu_torch import convert as C
from nngp_tpu_torch.models import baselines as TB
from nngp_tpu_torch.models import mscn as TM
from nngp_tpu_torch.models import tree_lstm as TT
from tests.test_torch_common import n

DTYPES = [(np.float32, 1e-6), (np.float64, 1e-12)]
IDS = ["fp32", "fp64"]


def _perturbed(params, dtype, seed=0):
    """The flax tree as numpy of `dtype`, every leaf moved by N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64)
                   + 0.1 * rng.standard_normal(a.shape)).astype(dtype),
        params)


def _load(module, state, dtype):
    module = module.to(torch.float64 if dtype == np.float64
                       else torch.float32)
    module.load_state_dict({k: v.to(next(module.parameters()).dtype)
                            for k, v in state.items()})
    return module.eval()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _x(shape, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_mlp_multitask_density_forward(dtype, atol):
    x = _x((9, 6), dtype)
    jm = JB.MLP(hid_ch=8, out_ch=2)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x[:1]), dtype)
    tm = _load(TB.MLP(6, 8, 2), C.mlp_state(p), dtype)
    _close(tm(_t(x)), jm.apply(p, x), atol)

    jm = JB.MultiTaskMLP(hid_ch=8, cla_out_ch=4)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x[:1]), dtype)
    tm = _load(TB.MultiTaskMLP(6, 8, cla_out_ch=4), C.multitask_state(p),
               dtype)
    (reg, logp), (jreg, jlogp) = tm(_t(x)), jm.apply(p, x)
    _close(reg, jreg, atol)
    _close(logp, jlogp, atol)
    np.testing.assert_allclose(n(logp.exp().sum(1)), 1.0, atol=1e-5)
    # multitask_loss on the same heads
    y = _x((9, 1), dtype, 2)
    classes = np.arange(9) % 4
    want = JB.multitask_loss(jreg, jlogp, y, jnp.asarray(classes), coeff=0.7)
    got = TB.multitask_loss(reg, logp, _t(y), _t(classes), coeff=0.7)
    assert float(got) == pytest.approx(float(want), rel=10 * atol)

    jm = JB.MLPDensityRegressor(hid_ch=8)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x[:1]), dtype)
    tm = _load(TB.MLPDensityRegressor(6, 8), C.density_state(p), dtype)
    (mu, sig), (jmu, jsig) = tm(_t(x)), jm.apply(p, x)
    _close(mu, jmu, atol)
    _close(sig, jsig, atol)
    assert float(sig.min()) > 0
    # the Gaussian NLL, sigma_pos a variance
    want = JB.MLPDensityRegressor.loss(y, jmu, jsig)
    assert float(TB.gaussian_nll(_t(y), mu, sig)) == \
        pytest.approx(float(want), rel=10 * atol)
    assert TB.MLPDensityRegressor.loss is TB.gaussian_nll


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_mc_dropout_with_a_given_mask(dtype, atol):
    """flax draws the keep mask from a key; the same mask handed to the
    port gives the same stochastic forward and predictive moments."""
    x = _x((7, 5), dtype)
    jm = JB.MCDropoutModel(hid_ch=8, dropout=0.3, num_samples=6)
    key = jax.random.PRNGKey(3)
    p = _perturbed(jm.init(key, x[:1], rng=key), dtype)
    tm = _load(TB.MCDropoutModel(5, 8, dropout=0.3, num_samples=6),
               C.density_state(p), dtype)
    keep = np.asarray(jax.random.bernoulli(key, 0.7, (7, 8)))
    (mu, sig), (jmu, jsig) = tm(_t(x), keep=_t(keep)), jm.apply(p, x, rng=key)
    _close(mu, jmu, atol)
    _close(sig, jsig, atol)
    keys = jax.random.split(key, 6)
    keeps = np.stack([np.asarray(jax.random.bernoulli(k, 0.7, (7, 8)))
                      for k in keys])
    (mean, std), (jmean, jstd) = tm.predict(_t(x), keep=_t(keeps)), \
        jm.predict(p, x, key)
    _close(mean, jmean, atol)
    _close(std, jstd, 10 * atol)      # population std (ddof 0), as jnp.std
    # the model's own NLL loss (defined, unused by the trainer)
    y = _x((7, 1), dtype, 2)
    want = JB.MCDropoutModel.loss(jmu, y, jnp.asarray(0.3, dtype))
    got = TB.MCDropoutModel.loss(mu, _t(y), torch.tensor(0.3))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_mc_dropout_masks_from_a_generator():
    tm = TB.MCDropoutModel(5, 64, dropout=0.25, num_samples=50,
                           generator=torch.Generator().manual_seed(0))
    x = _t(_x((40, 5), np.float32))
    keep = tm.keep_mask((200, 64), torch.Generator().manual_seed(1))
    assert keep.dtype == torch.bool
    assert float(keep.float().mean()) == pytest.approx(0.75, abs=0.02)
    m1, s1 = tm.predict(x, torch.Generator().manual_seed(2))
    m2, s2 = tm.predict(x, torch.Generator().manual_seed(2))
    m3, _ = tm.predict(x, torch.Generator().manual_seed(3))
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    assert not torch.equal(m1, m3) and float(s1.min()) > 0


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_deep_ensemble_forward_loss_and_mixture_moments(dtype, atol):
    x, y = _x((9, 4), dtype), _x((9, 1), dtype, 2)
    je = JB.DeepEnsemble(num_models=3, hid_ch=8)
    p = _perturbed(je.init(jax.random.PRNGKey(0), x[:1]), dtype)
    te = _load(TB.DeepEnsemble(4, 3, 8), C.deep_ensemble_state(p), dtype)
    (mus, sig), (jmus, jsig) = te(_t(x)), je.apply(p, x)
    assert mus.shape == (3, 9, 1)
    _close(mus, jmus, atol)
    _close(sig, jsig, atol)
    assert float(te.loss(_t(x), _t(y))) == \
        pytest.approx(float(je.loss(p, x, y)), rel=10 * atol)
    (mean, std), (jmean, jstd) = te.predict(_t(x)), je.predict(p, x)
    _close(mean, jmean, atol)
    _close(std, jstd, 10 * atol)
    # sigma_pos enters the mixture as a variance, un-squared
    want_var = (np.mean(n(sig) + n(mus) ** 2, axis=0)
                - np.mean(n(mus), axis=0) ** 2)
    np.testing.assert_allclose(n(std) ** 2, np.maximum(want_var, 0).ravel(),
                               rtol=1e-5, atol=1e-6)


def _sets(dtype, batch=6, rows=5, feat=7, seed=4):
    """Zero-padded sets with a mask; set 0 is all padding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, rows, feat)).astype(dtype)
    mask = rng.random((batch, rows)) > 0.4
    mask[0] = False
    mask[1] = True
    return x * mask[..., None], mask


@pytest.mark.parametrize("pool", ["mean", "min"])
@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_set_convolution_masked_unmasked_and_all_padding(dtype, atol, pool):
    x, mask = _sets(dtype)
    jm = JM.SetConvolution(8, 6, pool_type=pool)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x[:1]), dtype)
    tm = _load(TM.SetConvolution(7, 8, 6, pool_type=pool),
               C.set_conv_state(p["params"], ""), dtype)
    # mask=None pools over the zero padding rows too
    _close(tm(_t(x)), jm.apply(p, x), atol)
    got = tm(_t(x), _t(mask))
    _close(got, jm.apply(p, x, jnp.asarray(mask)), atol)
    assert not got[0].any()           # the all-padding set pools to 0
    assert not np.allclose(n(got[2]), n(tm(_t(x))[2]))
    with pytest.raises(ValueError, match="pool type"):
        TM.SetConvolution(7, 8, 6, pool_type="max")


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_mscn_family_forward(dtype, atol):
    pred, pmask = _sets(dtype, feat=7)
    right, _ = _sets(dtype, rows=3, feat=7, seed=5)
    join, jmask = _sets(dtype, rows=2, feat=4, seed=6)
    table, tmask = _sets(dtype, rows=3, feat=3, seed=7)
    kw = dict(pred_hid_ch=8, pred_out_ch=6, mlp_hid_ch=5)

    jm = JM.MSCN(**kw)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), pred[:1]), dtype)
    tm = _load(TM.MSCN(7, **kw), C.mscn_state(p), dtype)
    _close(tm(_t(pred)), jm.apply(p, pred), atol)
    _close(tm(_t(pred), _t(pmask)), jm.apply(p, pred, jnp.asarray(pmask)),
           atol)

    kw.update(join_hid_ch=7, join_out_ch=4)
    jm = JM.MSCNJoin(**kw)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), pred[:1], right[:1],
                           join[:1]), dtype)
    tm = _load(TM.MSCNJoin(7, 4, **kw), C.mscn_join_state(p), dtype)
    _close(tm(_t(pred), _t(right), _t(join)),
           jm.apply(p, pred, right, join), atol)

    kw.update(table_hid_ch=6, table_out_ch=3)
    jm = JM.MSCNMultiJoin(**kw)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), table[:1], pred[:1],
                           join[:1]), dtype)
    tm = _load(TM.MSCNMultiJoin(3, 7, 4, **kw), C.mscn_multi_state(p), dtype)
    _close(tm(_t(table), _t(pred), _t(join)),
           jm.apply(p, table, pred, join), atol)
    _close(tm(_t(table), _t(pred), _t(join), _t(tmask), _t(pmask),
              _t(jmask)),
           jm.apply(p, table, pred, join, jnp.asarray(tmask),
                    jnp.asarray(pmask), jnp.asarray(jmask)), atol)


class _JaxCell(nn.Module):
    hidden: int

    @nn.compact
    def __call__(self, x):
        return JT._LSTMStep(self.hidden)(x)


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_lstm_converter_one_step_from_zero_state(dtype, atol):
    """flax's OptimizedLSTMCell keeps 4 input kernels and 4 recurrent
    kernels with one bias each; from a zero state only ii, ig, io and the
    biases under hi, hg, ho reach the output, and the converter packs
    exactly those. Every flax leaf is perturbed, the ones that multiply
    zeros included."""
    x = _x((5, 9), dtype)
    jm = _JaxCell(6)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), x[:1]), dtype)
    cell = p["params"]["_LSTMStep_0"]["OptimizedLSTMCell_0"]
    assert sorted(cell) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert sorted(cell["hi"]) == ["bias", "kernel"]
    assert sorted(cell["ii"]) == ["kernel"]
    tm = _load(TT.LSTMStep(9, 6), C.lstm_step_state(cell, ""), dtype)
    _close(tm(_t(x)), jm.apply(p, x), atol)
    # the explicit formula
    def sig(a):
        return 1.0 / (1.0 + np.exp(-a))
    pre = {g: x @ cell[f"i{g}"]["kernel"] + cell[f"h{g}"]["bias"]
           for g in "igo"}
    want = sig(pre["o"]) * np.tanh(sig(pre["i"]) * np.tanh(pre["g"]))
    _close(tm(_t(x)), want, 10 * atol)


@pytest.mark.parametrize("dtype,atol", DTYPES, ids=IDS)
def test_tree_lstm_forward(dtype, atol):
    left, lmask = _sets(dtype, feat=7)
    right, rmask = _sets(dtype, rows=3, feat=7, seed=5)
    join, jmask = _sets(dtype, rows=2, feat=4, seed=6)
    kw = dict(pred_hid_ch=8, pred_out_ch=6, join_hid_ch=7, join_out_ch=4,
              mlp_hid_ch=5)
    jm = JT.TreeLSTMJoin(**kw)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), left[:1], right[:1],
                           join[:1]), dtype)
    tm = _load(TT.TreeLSTMJoin(7, 4, **kw), C.tree_lstm_join_state(p), dtype)
    _close(tm(_t(left), _t(right), _t(join)),
           jm.apply(p, left, right, join), atol)
    _close(tm(_t(left), _t(right), _t(join), _t(lmask), _t(rmask),
              _t(jmask)),
           jm.apply(p, left, right, join, jnp.asarray(lmask),
                    jnp.asarray(rmask), jnp.asarray(jmask)), atol)

    rng = np.random.default_rng(8)
    b, levels, preds, feat, op, meta = 4, 2, 3, 6, 5, 3
    arrays = (rng.standard_normal((b, levels + 1, preds, feat)),
              rng.standard_normal((b, levels + 1, op)),
              rng.standard_normal((b, levels + 1, meta)),
              rng.standard_normal((b, levels, 2 * preds, feat)),
              rng.standard_normal((b, levels, op)),
              rng.standard_normal((b, levels, meta)),
              np.array([[True, True], [True, False], [False, False],
                        [True, True]]),
              rng.random((b, levels + 1, preds)) > 0.3,
              rng.random((b, levels, 2 * preds)) > 0.3)
    arrays = tuple(a if a.dtype == bool else a.astype(dtype) for a in arrays)
    kw = dict(op_out_ch=4, meta_out_ch=3, pred_hid_ch=8, pred_out_ch=6,
              lstm_hid_ch=7, mlp_hid_ch=5)
    jm = JT.TreeLSTMMultiJoin(**kw)
    jarrays = [jnp.asarray(a) for a in arrays]
    p = _perturbed(jm.init(jax.random.PRNGKey(1), *jarrays), dtype)
    tm = _load(TT.TreeLSTMMultiJoin(feat, op, meta, **kw),
               C.tree_lstm_multi_state(p), dtype)
    tarrays = [_t(a) for a in arrays]
    _close(tm(*tarrays), jm.apply(p, *jarrays), atol)
    _close(tm(*tarrays[:7]), jm.apply(p, *jarrays[:7]), atol)
    assert tm(*tarrays).shape == (b, 1)
    # a batch of single-table plans: one leaf, padded to one level that no
    # chain has. JAX clamps its read of the missing second leaf; the port's
    # chain loop stops at the last leaf. The output is the first leaf's.
    single = [a[:, :1] for a in arrays]
    single[6] = np.zeros((b, 1), bool)
    _close(tm(*(_t(a) for a in single)),
           jm.apply(p, *(jnp.asarray(a) for a in single)), atol)


def test_dense_init_follows_the_flax_law():
    """lecun-normal: a normal of variance 1/fan_in truncated at 2 std, and a
    zero bias; from a generator, so a seed fixes it."""
    layer = TB.dense(400, 300, torch.Generator().manual_seed(0))
    again = TB.dense(400, 300, torch.Generator().manual_seed(0))
    w = n(layer.weight)
    assert w.shape == (300, 400) and not n(layer.bias).any()
    assert np.array_equal(w, n(again.weight))
    std = np.sqrt(1.0 / 400)
    assert w.std() == pytest.approx(std, rel=0.02)
    assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    jw = np.asarray(nn.Dense(300).init(jax.random.PRNGKey(0),
                                       jnp.ones((1, 400)))["params"]["kernel"])
    assert jw.std() == pytest.approx(w.std(), rel=0.03)
    assert np.abs(jw).max() == pytest.approx(np.abs(w).max(), rel=0.02)
    ens = TB.DeepEnsemble(400, 3, 50, torch.Generator().manual_seed(0))
    assert n(ens.w_trunk).std() == pytest.approx(std, rel=0.03)
    assert not n(ens.b_trunk).any()
    assert not np.array_equal(n(ens.w_trunk[0]), n(ens.w_trunk[1]))


def test_flax_dense_to_linear_transposes():
    state = C.flax_dense_to_linear(
        {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.ones(3)}, "fc.")
    assert state["fc.weight"].shape == (3, 2)
    assert state["fc.weight"][2, 1] == 5.0 and state["fc.bias"].shape == (3,)
