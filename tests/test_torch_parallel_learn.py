"""Hyperparameter learning on the port's mesh tier against the JAX
package's, fp64 on the CPU: the DTC loss's row mask and the mesh-sharded
learn (`fit_kernel_hyperparams(mesh=)`), at p = 1, 2 and 4 gloo ranks
(`tests/torch_parallel_cases.py`).

Tolerances:
  - the masked DTC loss: rel 1e-10 to JAX's at the same mask-padded rows;
    its gradient summed over ranks: rel 1e-9 of each leaf's largest entry
    (the grad-safe duals' gradients differ by ~1e-9 between the packages,
    tests/test_torch_hyperopt.py);
  - learned values after a few Adam steps: rel 1e-6 to JAX's mesh learn
    (as the single-device learns are held, test_torch_hyperopt.py); the
    mesh learn at p = 1 equals the port's own learn bit for bit (one rank:
    the all-reduces are identities), at p > 1 rel 1e-9.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nngp_tpu.gp.hyperopt as JH
import nngp_tpu.parallel as JPAR
from tests.test_torch_common import rows
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)
THETA = {"log_w0": np.log(0.7), "log_w": np.log(1.3), "log_b": np.log(0.4),
         "log_reg": np.log(2e-3)}
ARD = {k: v for k, v in THETA.items() if k != "log_w0"}
LOSSES = (("scalar-nngp", "nngp", THETA), ("scalar-ntk", "ntk", THETA),
          ("ard-nngp", "nngp", dict(ARD, log_s=np.log(np.linspace(
              0.3, 1.7, 20)))))
LEARNS = (("scalar", dict(steps=6, max_points=None, dtc_m=16)),
          ("ard-subsample", dict(steps=4, max_points=64, dtc_m=16,
                                 ard=True)))
M = 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ------------------------------------------------------------ hyperopt
@pytest.fixture(scope="module")
def dtc_data():
    x = rows(75, seed=2, special=False)
    rng = np.random.default_rng(7)
    y = x[:, :3].sum(1, keepdims=True) / 300.0 + rng.normal(0, 0.3,
                                                            (75, 1))
    return {"x": x, "y": y, "m": M, "losses": LOSSES, "learns": LEARNS}


@pytest.fixture(scope="module")
def dtc_runs(dtc_data):
    return {p: on_ranks(p, "dtc", dtc_data) for p in WORLDS}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name,get,theta", LOSSES, ids=[c[0] for c in LOSSES])
def test_masked_dtc_loss_and_gradient_match_jax(dtc_data, dtc_runs, p, name,
                                                get, theta):
    """The rows padded to a multiple of p with mask-0 rows, split over the
    ranks: the loss (the same on every rank) and the gradient summed over
    ranks equal JAX's masked loss and its gradient."""
    x, y = dtc_data["x"], dtc_data["y"]
    pad = (-x.shape[0]) % p
    mask = jnp.asarray(np.concatenate([np.ones(75), np.zeros(pad)]))
    jx = jnp.asarray(np.concatenate([x, np.zeros((pad, 20))]))
    jy = jnp.asarray(np.concatenate([y, np.zeros((pad, 1))]))
    duals = JH._grad_safe_duals(1e-12)
    jfn = jax.jit(jax.value_and_grad(lambda th: JH._nll_dtc(
        th, jx, jy, M, 1, "relu", 512, get, duals, mask=mask)))
    for r in dtc_runs[p]:
        val, grads = r["losses"][name]
        for i, shift in enumerate((0.0, 0.05)):
            jval, jgrad = jfn({k: jnp.asarray(v + shift)
                               for k, v in theta.items()})
            np.testing.assert_allclose(val[i], float(jval), rtol=1e-10)
            for k in theta:
                assert _rel(grads[k][i], jgrad[k]) < 1e-9, k


def test_masked_rows_contribute_nothing(dtc_data):
    """A row with mask 0 is as good as absent: the loss equals the
    unmasked loss of the rows that remain."""
    import torch

    from nngp_tpu_torch.gp import hyperopt as H

    x, y = torch.as_tensor(dtc_data["x"]), torch.as_tensor(dtc_data["y"])
    keep = torch.ones(75, dtype=x.dtype)
    keep[[20, 33, 34, 70]] = 0.0
    duals = H._grad_safe_duals(1e-12)
    th = {k: torch.tensor([v]) for k, v in THETA.items()}
    for get in ("nngp", "ntk"):
        masked = H._nll_dtc(th, x, y, M, 1, "relu", 512, get, duals,
                            mask=keep)
        live = keep.bool()
        plain = H._nll_dtc(th, x[live], y[live], M, 1, "relu", 512, get,
                           duals)
        np.testing.assert_allclose(masked.numpy(), plain.numpy(),
                                   rtol=1e-12)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in LEARNS])
def test_mesh_learn_matches_the_learn_without_a_mesh(dtc_runs, p, name):
    for r in dtc_runs[p]:
        mesh, plain = r["learns"][name]
        assert mesh["num_points"] == plain["num_points"]
        for key in ("w0", "w", "b", "diag_reg", "log_evidence", "hist",
                    "feature_scale"):
            if mesh[key] is None:
                assert plain[key] is None
            elif p == 1:
                np.testing.assert_array_equal(mesh[key], plain[key])
            else:
                assert _rel(mesh[key], plain[key]) < 1e-9, key


@pytest.mark.parametrize("name,kw", LEARNS, ids=[c[0] for c in LEARNS])
def test_mesh_learn_matches_jax_mesh_learn(dtc_data, dtc_runs, name, kw):
    """The JAX package's GSPMD learn on 2 of its virtual devices."""
    res = JH.fit_kernel_hyperparams(dtc_data["x"], dtc_data["y"],
                                    objective="dtc",
                                    mesh=JPAR.make_mesh(2), **kw)
    got = dtc_runs[2][0]["learns"][name][0]
    assert got["num_points"] == res.num_points
    for key in ("w0", "w", "b", "diag_reg"):
        np.testing.assert_allclose(got[key], getattr(res, key), rtol=1e-6)
    np.testing.assert_allclose(got["log_evidence"], res.log_evidence,
                               rtol=1e-6)
    np.testing.assert_allclose(got["hist"], res.nll_history, rtol=1e-8)
    if res.feature_scale is not None:
        np.testing.assert_allclose(got["feature_scale"], res.feature_scale,
                                   rtol=1e-6)
