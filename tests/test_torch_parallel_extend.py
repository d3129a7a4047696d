"""`DistributedPosterior.extend` of the port against the JAX package's and
against a refit, fp64 on the CPU.

A ragged fit (61 rows, block size 4, input_scale 2) is extended by 3 rows
(they fit into the inert pad slots) and by 11 rows (storage grows by whole
p * block_size quanta), then by 5 more on top. The port runs p = 1, 2 and
4 gloo ranks (`tests/torch_parallel_cases.py`); JAX runs p = 2 of its
virtual devices, under `jax.jit` (each mesh program costs about a second
to compile here, so one world size is held to JAX and every world size to
the refit).

Tolerances: against JAX, nngp 1e-10 and ntk 1e-6 of the largest value
(the generic NTK diagonal at rho = 1, as in
test_torch_parallel_posterior.py); extend against a refit on the merged
rows with the fit's ridge: max |d mean| <= 1e-6 max |mean|, the bound the
single-device tier's extend is held to.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nngp_tpu.parallel as JPAR
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from tests.test_torch_common import jax_spec
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)
TOL = {"nngp": 1e-10, "ntk": 1e-6}
M_NEW = (3, 11)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)

    def ints(*shape):
        return rng.integers(0, 1000, shape).astype(np.float64)

    return {"spec": reference_kernel(), "x": ints(61, 10),
            "y": rng.standard_normal((61, 1)), "xt": ints(16, 10),
            "x_new": ints(11, 10), "y_new": rng.standard_normal((11, 1)),
            "x2": ints(5, 10), "y2": rng.standard_normal((5, 1)),
            "b": 4, "input_scale": 2.0, "m_new": M_NEW}


@pytest.fixture(scope="module")
def runs(data):
    return {p: on_ranks(p, "extend", data) for p in WORLDS}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
@pytest.mark.parametrize("m_new", M_NEW)
def test_extend_matches_refit(data, runs, p, get, m_new):
    quantum = 4 * p
    for r in runs[p]:
        got = r[get, m_new]
        assert got["train"] == 61 + m_new
        want_pad = max(64, quantum * -(-(61 + m_new) // quantum))
        assert got["padded"] == want_pad
        if m_new == 3:
            assert got["padded"] == 64            # reused the pad slots
        np.testing.assert_array_equal(
            got["x"] * 2.0, np.concatenate([data["x"],
                                            data["x_new"][:m_new]]))
        np.testing.assert_array_equal(
            got["y"], np.concatenate([data["y"], data["y_new"][:m_new]]))
        mean, refit = got["mean_std"][0], got["refit"][0]
        assert _rel(mean, refit) <= 1e-6
        assert _rel(got["mean_std"][1], got["refit"][1]) <= 1e-6


@pytest.mark.parametrize("get", ["nngp", "ntk"])
@pytest.mark.parametrize("m_new", M_NEW)
def test_extend_matches_jax(data, runs, get, m_new):
    spec = jax_spec(data["spec"])
    mesh = JPAR.make_mesh(2)
    post = jax.jit(lambda x, y: JPAR.distributed_fit(
        spec, x, y, mesh, get=get, block_size=data["b"],
        input_scale=data["input_scale"]))(jnp.asarray(data["x"]),
                                          jnp.asarray(data["y"]))
    ext = post.extend(jnp.asarray(data["x_new"][:m_new]),
                      jnp.asarray(data["y_new"][:m_new]))
    ext2 = ext.extend(jnp.asarray(data["x2"]), jnp.asarray(data["y2"]))
    xt = jnp.asarray(data["xt"])
    mean, std = ext.predict_mean_std(xt)
    mean2, std2 = ext2.predict_mean_std(xt)
    tol = TOL[get]
    for r in runs[2]:
        got = r[get, m_new]
        assert got["padded"] == ext.num_padded
        assert _rel(got["alpha"], ext.alpha_natural()) < tol
        assert _rel(got["mean_std"][0], mean) < tol
        assert _rel(got["mean_std"][1], std) < tol
        assert _rel(got["ext2"][0], mean2) < tol
        assert _rel(got["ext2"][1], std2) < tol
