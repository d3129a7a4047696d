"""The port's `distributed_fit` / `DistributedPosterior` against the JAX
package's at p = 1, 2 and 4 ranks, fp64 on the CPU: alpha, the
natural-order rows, predict_mean_std, predict with the full and the
diagonal covariance and without it, the log evidence, a chunked predict,
and the converter from a JAX posterior's arrays (`convert.py`).

The training set is ragged (61 rows, block size 4: the layout pads it
with inert rows) and prescaled (input_scale 2). The rows are integers, so
K0 is exact in both packages. JAX runs each call under `jax.jit` on p of
its 8 virtual devices; the port runs p gloo ranks
(`tests/torch_parallel_cases.py`), and every rank must return the same
replicated result.

Tolerances (max |port - JAX| / max |JAX|): nngp 1e-10 (the same products
summed in other orders). ntk 1e-6: the distributed Gram is a cross Gram,
so its diagonal carries the generic NTK dual at rho = 1, where each
package's acos rounds its own way (~2e-9 of the diagonal, ROADMAP Queue
C), and the 1e-3 relative ridge's solve amplifies that.
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return {"spec": reference_kernel(),
            "x": rng.integers(0, 1000, (61, 10)).astype(np.float64),
            "y": rng.standard_normal((61, 1)),
            "xt": rng.integers(0, 1000, (24, 10)).astype(np.float64),
            "b": 4, "input_scale": 2.0}


@pytest.fixture(scope="module")
def runs(data):
    return {p: on_ranks(p, "posterior", data) for p in WORLDS}


@pytest.fixture(scope="module")
def jax_posts(data):
    spec = jax_spec(data["spec"])
    out = {}
    for p in WORLDS:
        mesh = JPAR.make_mesh(p)
        for get in ("nngp", "ntk"):
            post = jax.jit(lambda x, y, get=get: JPAR.distributed_fit(
                spec, x, y, mesh, get=get, block_size=data["b"],
                input_scale=data["input_scale"]))(
                    jnp.asarray(data["x"]), jnp.asarray(data["y"]))
            out[p, get] = post
    return out


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_fit_and_predict_match_jax(data, runs, jax_posts, p, get):
    post = jax_posts[p, get]
    xt = jnp.asarray(data["xt"])
    mean, std = post.predict_mean_std(xt)
    cov_mean, cov = post.predict(xt, compute_cov=True)
    _, var = post.predict(xt, compute_cov="diag")
    tol = TOL[get]
    for r in runs[p]:
        got = r[get]
        assert got["padded"] == post.num_padded == 64
        assert got["train"] == post.num_train == 61
        assert _rel(got["alpha"], post.alpha_natural()) < tol
        np.testing.assert_array_equal(got["x"] * 2.0, data["x"])
        np.testing.assert_array_equal(got["y"], data["y"])
        assert _rel(got["mean_std"][0], mean) < tol
        assert _rel(got["mean_std"][1], std) < tol
        assert _rel(got["cov"][0], cov_mean) < tol
        assert _rel(got["cov"][1], cov) < tol
        assert _rel(got["diag"][1], var) < tol
        assert _rel(got["mean_only"], mean) < tol
        np.testing.assert_allclose(got["lml"],
                                   float(post.log_marginal_likelihood()),
                                   rtol=tol)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_every_rank_returns_the_same_result(runs, p, get):
    first = runs[p][0][get]
    for r in runs[p][1:]:
        for key in ("alpha", "mean_std", "cov", "lml", "chunked"):
            got, want = r[get][key], first[key]
            for g, w in (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)]):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_chunked_predict_matches_direct(runs, p, get):
    r = runs[p][0][get]
    mean, std = r["chunked"]
    assert mean.shape == std.shape == (24,)
    np.testing.assert_allclose(mean, r["mean_std"][0].ravel(), rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(mean)))
    np.testing.assert_allclose(std, r["mean_std"][1], rtol=1e-12,
                               atol=1e-12 * np.max(std))


@pytest.mark.parametrize("p", WORLDS)
def test_world_sizes_agree(runs, p):
    """The layout's storage order cancels: every world size gives the
    same posterior up to summation order."""
    for get in ("nngp", "ntk"):
        for key in ("alpha", "mean_std", "cov"):
            got, want = runs[p][0][get][key], runs[1][0][get][key]
            if isinstance(got, tuple):
                for g, w in zip(got, want):
                    assert _rel(g, w) < 1e-10
            else:
                assert _rel(got, want) < 1e-10


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_gather_state_lands_on_rank_zero_only(runs, jax_posts, p, get):
    """The checkpoint gather: rank 0 gets every rank's shards stacked in
    storage order on the host (the JAX posterior's arrays), the other
    ranks get None."""
    post = jax_posts[p, get]
    state = runs[p][0][get]["state"]
    names = ["x_storage", "y_storage", "l", "alpha"] + (
        ["k_tt"] if get == "ntk" else [])
    assert sorted(state) == sorted(names + ["reg"])
    for name in names:
        stacked = np.concatenate([r[get]["shards"][name] for r in runs[p]])
        np.testing.assert_array_equal(state[name], stacked)
        assert _rel(state[name], np.asarray(getattr(post, name))) < TOL[get]
    assert _rel(state["reg"], post.reg) < 1e-12
    assert all(r[get]["state"] is None for r in runs[p][1:])


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_posterior_from_jax_arrays_predicts_what_jax_predicts(data,
                                                              jax_posts, get):
    """convert.distributed_from_numpy: a JAX DistributedPosterior's arrays
    become the port's posterior, one shard per rank, at p = 2."""
    post = jax_posts[2, get]
    arrs = {k: np.asarray(getattr(post, k)) for k in
            ("x_storage", "y_storage", "l", "alpha", "reg")}
    if get == "ntk":
        arrs["k_tt"] = np.asarray(post.k_tt)
    pl = {"arrs": arrs, "spec": data["spec"], "get": get,
          "block_size": post.block_size, "n_real": post.num_train,
          "input_scale": post.input_scale, "g2e": np.asarray(post.g2e),
          "xt": data["xt"]}
    xt = jnp.asarray(data["xt"])
    mean, std = post.predict_mean_std(xt)
    _, cov = post.predict(xt, compute_cov=True)
    for r in on_ranks(2, "from_jax", pl):
        # the same factor: only the predict's own sums differ
        assert _rel(r["mean_std"][0], mean) < 1e-12
        assert _rel(r["mean_std"][1], std) < 1e-10
        assert _rel(r["cov"][1], cov) < 1e-10
        assert _rel(r["alpha"], post.alpha_natural()) == 0.0
        np.testing.assert_allclose(r["lml"],
                                   float(post.log_marginal_likelihood()),
                                   rtol=1e-12)


def test_from_jax_refuses_another_layout(data, jax_posts):
    from nngp_tpu_torch.convert import distributed_from_numpy
    from nngp_tpu_torch.parallel import make_mesh

    post = jax_posts[2, "nngp"]
    arrs = {k: np.asarray(getattr(post, k)) for k in
            ("x_storage", "y_storage", "l", "alpha", "reg")}
    # the p = 2 cyclic order is not the p = 1 order of the same n and b
    with pytest.raises(ValueError, match="storage order"):
        distributed_from_numpy(arrs, data["spec"], "nngp",
                               make_mesh(1, device="cpu"), post.block_size,
                               post.num_train, g2e=np.asarray(post.g2e))
    with pytest.raises(ValueError, match="block_size"):
        distributed_from_numpy(arrs, data["spec"], "nngp",
                               make_mesh(1, device="cpu"), 48,
                               post.num_train)
