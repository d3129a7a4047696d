"""`nngp_tpu_torch.ops.iterative` against `nngp_tpu.ops.iterative` on the
same seeded numpy inputs, fp64 on the CPU.

CG: the same solution as JAX's at 1e-10 and the same iteration count (JAX's
`lax.while_loop` rule is kept as a Python loop), and a direct solve. Lanczos:
the tridiagonal coefficients on a fixed probe block at 1e-9. SLQ: JAX's own
probes give JAX's log-determinant at 1e-8; the port's generator gives the
exact log-determinant within 5%, the JAX test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.ops import iterative as JI
from nngp_tpu_torch.ops import iterative as TI
from tests.test_torch_common import n, t


def _spd(size, seed, lo=0.5, hi=20.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((size, size)))
    evals = np.linspace(lo, hi, size)
    return (q * evals) @ q.T, evals


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_batched_cg_matches_jax_and_a_direct_solve(tol):
    a, _ = _spd(120, 0)
    b = np.random.default_rng(1).standard_normal((120, 5))
    b[:, 2] = 0.0                        # a zero column: the 0/0 guards
    calls = []

    def mvm(v):
        calls.append(1)
        return t(a) @ v

    got = n(TI.batched_cg(mvm, t(b), tol=tol, max_iters=400))
    aj = jnp.asarray(a)
    want = n(JI.batched_cg(lambda v: aj @ v, jnp.asarray(b), tol=tol,
                           max_iters=400))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    direct = np.linalg.solve(a, b)
    np.testing.assert_allclose(got, direct, rtol=0,
                               atol=50 * tol * np.abs(direct).max())
    # the same number of iterations as JAX: capped one short of it, JAX's
    # answer moves; capped at it, it does not
    iters = len(calls)
    assert 0 < iters < 400
    at = n(JI.batched_cg(lambda v: aj @ v, jnp.asarray(b), tol=tol,
                         max_iters=iters))
    short = n(JI.batched_cg(lambda v: aj @ v, jnp.asarray(b), tol=tol,
                            max_iters=iters - 1))
    np.testing.assert_array_equal(at, want)
    assert np.abs(short - want).max() > 0


def test_batched_cg_stops_at_max_iters_and_on_zero_rhs():
    a, _ = _spd(60, 2, hi=5000.0)
    b = np.random.default_rng(3).standard_normal((60, 2))
    calls = []

    def mvm(v):
        calls.append(1)
        return t(a) @ v

    got = n(TI.batched_cg(mvm, t(b), tol=1e-12, max_iters=7))
    aj = jnp.asarray(a)
    want = n(JI.batched_cg(lambda v: aj @ v, jnp.asarray(b), tol=1e-12,
                           max_iters=7))
    assert len(calls) == 7
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    calls.clear()
    zero = TI.batched_cg(mvm, torch.zeros(60, 2, dtype=torch.float64))
    assert not calls and not zero.any()


def test_lanczos_coefficients_match_jax():
    a, _ = _spd(90, 4)
    q0 = np.where(np.random.default_rng(5).random((90, 6)) < 0.5, 1.0, -1.0)
    aj = jnp.asarray(a)
    ja, jb, jn_ = JI._batched_lanczos(lambda v: aj @ v, jnp.asarray(q0), 12)
    ta, tb, tn = TI.batched_lanczos(lambda v: t(a) @ v, t(q0), 12)
    assert ta.shape == (12, 6) and tb.shape == (11, 6)
    np.testing.assert_allclose(n(ta), n(ja), rtol=1e-9)
    np.testing.assert_allclose(n(tb), n(jb), rtol=1e-9)
    np.testing.assert_allclose(n(tn), n(jn_), rtol=1e-14)


def test_slq_logdet_with_jax_probes_matches_jax():
    a, _ = _spd(200, 6)
    key = jax.random.PRNGKey(0)
    aj = jnp.asarray(a)
    want = float(JI.slq_logdet(lambda v: aj @ v, 200, key, num_probes=16,
                               num_iters=25, dtype=jnp.float64))
    probes = np.where(np.asarray(jax.random.bernoulli(key, 0.5, (200, 16))),
                      1.0, -1.0)
    got = float(TI.slq_logdet(lambda v: t(a) @ v, 200, probes=t(probes),
                              num_iters=25, dtype=torch.float64))
    assert got == pytest.approx(want, rel=1e-8)


def test_slq_logdet_from_a_generator_is_close_to_exact():
    a, evals = _spd(300, 3)
    want = float(np.sum(np.log(evals)))
    gen = torch.Generator().manual_seed(0)
    got = float(TI.slq_logdet(lambda v: t(a) @ v, 300, gen, num_probes=32,
                              num_iters=30, dtype=torch.float64))
    assert abs(got - want) / abs(want) < 0.05
    # the same seed draws the same probes
    again = float(TI.slq_logdet(lambda v: t(a) @ v, 300,
                                torch.Generator().manual_seed(0),
                                num_probes=32, num_iters=30,
                                dtype=torch.float64))
    assert again == got
    z = TI.rademacher((1000, 4), torch.Generator().manual_seed(1),
                      torch.float32)
    assert z.dtype == torch.float32 and set(z.unique().tolist()) == {-1., 1.}
    assert abs(float(z.mean())) < 0.1
    with pytest.raises(ValueError, match="generator or the probes"):
        TI.slq_logdet(lambda v: v, 10)
