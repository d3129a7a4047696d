"""`ActiveLearner(mesh=)` of the port, at p = 1, 2 and 4 gloo ranks
(`tests/torch_parallel_cases.py`), against the JAX package's learner, on
the CPU, fp64.

Tolerance: the validation MSE of every round to rel 1e-6 of the JAX
package's incremental single-device learner, the relation the JAX
package's own mesh learner is held to (tests/test_parallel.py); the JAX
mesh learner itself is not run: its fit is an eager shard_map that takes
~15 s a call here.
"""

import numpy as np
import pytest

from nngp_tpu.active import ActiveLearner as JaxLearner
from nngp_tpu_torch.models.kernel_spec import reference_kernel
from tests.test_torch_common import jax_spec
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)


# ------------------------------------------------------ active learning
def _split(seed, n_tr, n_pool, d):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 100, (n_tr, d)), rng.standard_normal((n_tr, 1)),
            rng.uniform(0, 100, (n_pool, d)),
            rng.standard_normal((n_pool, 1)),
            rng.uniform(0, 100, (16, d)), rng.standard_normal((16, 1)))


LEARNERS = (
    ("topk", dict(data="a", budget=16, active_iters=2, biased_sample=False)),
    ("ragged", dict(data="b", budget=21, active_iters=1,
                    biased_sample=False, dist_block_size=2)),
    ("greedy", dict(data="a", budget=8, active_iters=2,
                    selection="greedy")),
)


@pytest.fixture(scope="module")
def active_data():
    return {"spec": reference_kernel(), "learners": LEARNERS,
            "data": {"a": _split(3, 32, 64, 6), "b": _split(5, 33, 40, 4)}}


@pytest.fixture(scope="module")
def active_runs(active_data):
    return {p: on_ranks(p, "active", active_data) for p in WORLDS}


@pytest.fixture(scope="module")
def jax_active(active_data):
    out = {}
    for name, kw in LEARNERS:
        kw = dict(kw)
        kw.pop("dist_block_size", None)
        data = active_data["data"][kw.pop("data")]
        learner = JaxLearner(jax_spec(active_data["spec"]),
                             refit="incremental", **kw)
        _, hist = learner.active_train(*data, printer=None)
        out[name] = hist
    return out


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in LEARNERS])
def test_active_learner_over_a_mesh_matches_jax(active_runs, jax_active, p,
                                                name):
    """Top-k, a ragged budget with block size 2 (the full budget is
    acquired: the layout pads), and greedy selection, whose (P, P) pool
    covariance comes from the sharded posterior's predict(True)."""
    want = jax_active[name]
    for r in active_runs[p]:
        got = r[name]
        assert got["num_train"] == [h["num_train"] for h in want]
        np.testing.assert_allclose(got["hist"],
                                   [h["val_mse"] for h in want], rtol=1e-6)
        assert got["final"][2] == "DistributedPosterior"
        assert got["final"][0] == want[-1]["num_train"]
