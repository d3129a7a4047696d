"""The Nystrom tier's mesh moments (`fit_nystrom(mesh=)`, and extend and
forget through the posterior's mesh) against the fit without a mesh and
against the JAX package's mesh fit (`_sharded_panel_fn`), at p = 1, 2 and
4 gloo ranks (`tests/torch_parallel_cases.py`), on the CPU.

The rows are integers, so K0 is exact in both packages. Tolerances: the
mesh fit equals the mesh-less fit bit for bit at p = 1 and to rel 1e-12 at
p > 1 (the same row sums in another order); to JAX's mesh fit rel 1e-9
nngp and 1e-7 ntk (the generic NTK dual at rho = 1, as in
tests/test_torch_nystrom.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import nngp_tpu.parallel as JPAR
from nngp_tpu.gp import fit_nystrom as jax_fit_nystrom
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from tests.test_torch_common import jax_spec
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------- Nystrom
ARMS = (("nngp", "fp32"), ("ntk", "fp32"), ("nngp", "df64"))


@pytest.fixture(scope="module")
def ny_data():
    rng = np.random.default_rng(11)

    def ints(*shape):
        return rng.integers(0, 1000, shape).astype(np.float64)

    return {"spec": reference_kernel(), "x": ints(150, 20),
            "y": rng.standard_normal((150, 1)), "x_new": ints(9, 20),
            "y_new": rng.standard_normal((9, 1)), "xt": ints(12, 20),
            "m": 24, "panel": 37, "arms": ARMS}


@pytest.fixture(scope="module")
def ny_runs(ny_data):
    return {p: on_ranks(p, "nystrom", ny_data) for p in WORLDS}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get,moments", ARMS)
def test_nystrom_mesh_moments_match_the_fit_without_a_mesh(ny_runs, p, get,
                                                           moments):
    """Panels of 37 rows split over the ranks (the panel rounded up to a
    multiple of p, a ragged tail): the summed moments, predictions, extend
    and forget of the mesh fit equal the mesh-less fit's (bit for bit at
    p = 1, rel 1e-12 at p > 1: sums in another order)."""
    for r in ny_runs[p]:
        arm = r[get, moments]
        mesh, plain = arm["mesh"], arm["plain"]
        assert mesh["has_mesh"] == (True, True)
        assert mesh["num_train"] == plain["num_train"] == (150, 159)
        pairs = list(zip(mesh["moments"], plain["moments"])) + [
            (mesh["back_c"], plain["back_c"]),
            (mesh["evidence"], plain["evidence"])] + list(
            zip(mesh["mean_std"] + mesh["ext"],
                plain["mean_std"] + plain["ext"]))
        for got, want in pairs:
            if want is None:
                assert got is None
            elif p == 1:
                np.testing.assert_array_equal(got, want)
            else:
                assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_nystrom_mesh_fit_matches_jax(ny_data, ny_runs, p, get):
    spec = jax_spec(ny_data["spec"])
    jpost = jax_fit_nystrom(spec, ny_data["x"], ny_data["y"],
                            num_inducing=ny_data["m"], get=get,
                            panel_size=ny_data["panel"], input_scale=1.0,
                            mesh=JPAR.make_mesh(p))
    jext = jpost.extend(jnp.asarray(ny_data["x_new"]),
                        jnp.asarray(ny_data["y_new"]))
    xt = jnp.asarray(ny_data["xt"])
    tol = 1e-9 if get == "nngp" else 1e-7
    for r in ny_runs[p]:
        got = r[get, "fp32"]["mesh"]
        for g, w in zip(got["moments"][3:], (jpost.diag_sum, jpost.yty)):
            assert _rel(g, w) < tol
        for g, w in zip(got["mean_std"] + got["ext"],
                        jpost.predict_mean_std(xt)
                        + jext.predict_mean_std(xt)):
            assert _rel(np.ravel(g), np.ravel(w)) < tol
