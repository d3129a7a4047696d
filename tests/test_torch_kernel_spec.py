"""The port's duals and kernel recursion (`nngp_tpu_torch.ops.dual_activations`,
`nngp_tpu_torch.models.kernel_spec`) against the JAX package in fp64.

Tolerances: the duals on identical covariance inputs agree to rtol 1e-12
(the two packages use different acos/asin implementations, each good to an
ulp or so). Through the whole recursion, from raw features: rtol 1e-10 for
nngp and 1e-7 for ntk. The two packages sum x1 @ x2.T in different orders,
and acos's slope at rho -> 1 turns a one-ulp difference in K0 into about
1e-8 in theta, which the NTK's (pi - theta) / (2 pi) multiplier carries
straight into its value; the nngp dual is flat there (its error is
O(theta^2)).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nngp_tpu.models import kernel_spec as jk
from nngp_tpu.ops import dual_activations as jd
from nngp_tpu_torch.convert import layers_from_jax
from nngp_tpu_torch.models import kernel_spec as tk
from nngp_tpu_torch.ops import dual_activations as td
from tests.test_torch_common import jax_spec, n, rows, t

ACTS = ("relu", "erf", "sin", "abs")


def _cov_triples(seed=0, size=400):
    """(k12, k11, k22) with rho spread over [-1, 1], rho = +-1 and 0
    exactly, and zero-variance entries."""
    rng = np.random.default_rng(seed)
    k11 = rng.uniform(0.0, 3.0, size)
    k22 = rng.uniform(0.0, 3.0, size)
    rho = rng.uniform(-1.0, 1.0, size)
    rho[:3] = (1.0, -1.0, 0.0)
    k11[3:6] = 0.0
    k12 = rho * np.sqrt(k11 * k22)
    return k12, k11, k22


def _close(got, want, rtol):
    got, want = n(got), n(want)
    atol = 1e-14 * max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("act", ACTS)
def test_duals_match_jax(act):
    k12, k11, k22 = _cov_triples()
    for f_t, f_j in zip(td.DUALS[act][:2], jd.DUALS[act][:2]):
        _close(f_t(t(k12), t(k11), t(k22)),
               f_j(jnp.asarray(k12), jnp.asarray(k11), jnp.asarray(k22)),
               1e-12)
    _close(td.DUALS[act][2](t(k11)), jd.DUALS[act][2](jnp.asarray(k11)),
           1e-12)
    _close(td.DUALS_NTK_DIAG[act](t(k11)),
           jd.DUALS_NTK_DIAG[act](jnp.asarray(k11)), 1e-12)


def test_relu_dual_zero_row_floor_is_finite():
    """The 1e-36 floor: a zero-variance row gives ~1e-18, not 0 * inf."""
    z = t(np.zeros(3))
    k = t(np.array([0.0, 1.0, 5.0]))
    for f in (td.relu_nngp, td.relu_ntk_mult, td.abs_nngp, td.abs_ntk_mult):
        out = n(f(z, z, k))
        assert np.all(np.isfinite(out))
    assert np.all(n(td.relu_nngp(z, z, k)) < 1e-17)


SPECS = [(act, depth, b_std) for act in ACTS for depth in (1, 2, 3)
         for b_std in (0.0, 0.1)]


def _spec(act, depth, b_std):
    return tk.KernelSpec(tk.mlp(depth, activation=act, b_std=b_std))


@pytest.mark.parametrize("act,depth,b_std", SPECS)
def test_kernel_eval_matches_jax(act, depth, b_std):
    spec = _spec(act, depth, b_std)
    x1, x2 = rows(24, seed=1), rows(31, seed=2)
    x1[5] = x2[2]   # a cross pair at rho = 1
    want_k, want_t = jk.kernel_eval(jax_spec(spec).layers, jnp.asarray(x1),
                                    jnp.asarray(x2), ("nngp", "ntk"))
    got_k, got_t = tk.kernel_eval(spec.layers, t(x1), t(x2), ("nngp", "ntk"))
    np.testing.assert_allclose(n(got_k), n(want_k), rtol=1e-10)
    np.testing.assert_allclose(n(got_t), n(want_t), rtol=1e-7)
    # KernelSpec.kernel_fn is the same function
    np.testing.assert_array_equal(n(spec.kernel_fn(t(x1), t(x2), "ntk")),
                                  n(got_t))


@pytest.mark.parametrize("act,depth,b_std", SPECS)
def test_diag_and_self_kernel_match_jax(act, depth, b_std):
    spec = _spec(act, depth, b_std)
    jlayers = jax_spec(spec).layers
    x = rows(29, seed=3)
    for get, rtol in (("nngp", 1e-10), ("ntk", 1e-7)):
        np.testing.assert_allclose(
            n(tk.diag_eval(spec.layers, t(x), get)),
            n(jk.diag_eval(jlayers, jnp.asarray(x), get)), rtol=1e-10)
        got = n(tk.self_kernel_eval(spec.layers, t(x), get))
        want = n(jk.self_kernel_eval(jlayers, jnp.asarray(x), get))
        np.testing.assert_allclose(got, want, rtol=rtol)
        # the exact diagonal is written in place of the computed one
        np.testing.assert_array_equal(np.diag(got),
                                      n(spec.diag_fn(t(x), get)))
    dn, dt = tk.apply_diag_recursion(t(x).square().mean(-1), spec.layers)
    jn, jt = jk.apply_diag_recursion(jnp.asarray(x ** 2).mean(-1), jlayers)
    np.testing.assert_allclose(n(dn), n(jn), rtol=1e-12)
    np.testing.assert_allclose(n(dt), n(jt), rtol=1e-12)


@pytest.mark.parametrize("layers", [
    (tk.Dense(512), tk.Relu(), tk.Dense(1)),
    (tk.Dense(64), tk.Activation("abs"), tk.Dense(64), tk.Relu(),
     tk.Dense(1)),
    (tk.Dense(512, b_std=0.1), tk.Relu(), tk.Dense(1)),
    (tk.Dense(512), tk.Erf(), tk.Dense(1)),
    (tk.Dense(512), tk.Activation("sin"), tk.Dense(1)),
    (tk.Dense(512, w_std=2.0), tk.Relu(), tk.Dense(1, w_std=0.5)),
])
def test_is_scale_equivariant_matches_jax(layers):
    spec = tk.KernelSpec(layers)
    assert tk.is_scale_equivariant(layers) == jk.is_scale_equivariant(
        jax_spec(spec).layers)
    if tk.is_scale_equivariant(layers):
        # kernel(s x1, s x2) == s^2 kernel(x1, x2), exactly for s = 2^k
        # (no zero row: its floored ~1e-18 entries do not scale)
        x = rows(9, seed=4, special=False)
        base = n(tk.kernel_eval(layers, t(x), get="ntk"))
        scaled = n(tk.kernel_eval(layers, t(x * 8.0), get="ntk"))
        np.testing.assert_allclose(scaled, 64.0 * base, rtol=1e-12)


def test_mlp_and_reference_kernel_match_jax_structure():
    for depth, act, w, b in ((1, "relu", 1.0, 0.0), (3, "erf", 1.5, 0.1)):
        assert layers_from_jax(jk.mlp(depth, 512, act, w, b)) == tk.mlp(
            depth, 512, act, w, b)
    assert tk.KernelSpec(layers_from_jax(jk.reference_kernel().layers)) == \
        tk.reference_kernel()
    assert hash(tk.reference_kernel()) == hash(tk.reference_kernel())
    with pytest.raises(ValueError, match="start with a Dense"):
        tk.KernelSpec((tk.Relu(), tk.Dense(1)))
    with pytest.raises(ValueError, match="Unknown activation"):
        tk.Activation("tanh")
    with pytest.raises(ValueError, match="get must be"):
        tk.kernel_eval(tk.mlp(), t(rows(4)), get="both")
