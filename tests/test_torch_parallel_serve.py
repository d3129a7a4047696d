"""The port's Estimator on the distributed tier (`Estimator(mesh=,
tier='distributed')`) at p = 1, 2 and 4 gloo ranks
(`tests/torch_parallel_cases.py`), against the JAX package's Estimator,
on the toy two-table schema of tests/test_active_serve.py, fp64 on the
CPU; checkpoints in both directions; the front ends at world size 1
(above it: test_torch_parallel_follower.py).

Tolerances (max |port - JAX| / max |JAX|): predictions against the JAX
single-device Estimator (whose small-n fit, like the distributed tier,
evaluates the Gram's diagonal with the generic dual) 1e-9 nngp and 1e-6
ntk (each package rounds the generic NTK dual at rho = 1 its own way,
~2e-9 of the diagonal); a checkpoint restored in the other package
predicts what it saved to 1e-10 (the same factor, the predict's own sums).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nngp_tpu.parallel as JPAR
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from tests.test_active_serve import _toy_schema_files
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)
TOL = {"nngp": 1e-9, "ntk": 1e-6}
LINES = ["ta,tb@x,5.0,-5.0@@ta,tb,id", "ta,tb@@y,0.9,0.1@ta,tb,id",
         "ta,tb@x,1.0,-2.0@@ta,tb,id", "ta,tb@x,9.5,0.5@@ta,tb,id",
         "ta,tb@x,5.0,-5.0@@ta,tb,id"]
BLOCK = 4


def _labeled(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xu = rng.uniform(-10, 10)
        xl = rng.uniform(-10, xu)
        out.append(f"ta,tb@x,{xu:.3f},{xl:.3f}@@ta,tb,id@"
                   f"{max(1, int(1000 * (xu - xl)))}")
    return out


NEW = _labeled(5, 7)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert _rel(g, w) < tol


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_schema_files(tmp_path_factory.mktemp("toy"))


@pytest.fixture(scope="module")
def jax_estimators(toy):
    stats, qdir = toy
    out = {}
    for get in ("nngp", "ntk"):
        jest = JaxEstimator("toy", None, qdir, stats=stats,
                            dtype=np.float64, verbose=False, kernel_type=get)
        out[get] = {"predict": jest.predict(LINES)}
        jest.extend_with_lines(NEW)
        out[get]["extended"] = jest.predict(LINES)
    return out


@pytest.fixture(scope="module")
def jax_ckpts(toy, tmp_path_factory):
    """Distributed checkpoints written by the JAX Estimator at p = 2: a
    single-device Estimator given a distributed posterior of its rows
    (fit under jax.jit) and the mesh, then saved."""
    stats, qdir = toy
    mesh = JPAR.make_mesh(2)
    out = {}
    for get in ("nngp", "ntk"):
        jest = JaxEstimator("toy", None, qdir, stats=stats,
                            dtype=np.float64, verbose=False, kernel_type=get)
        post = jest.posterior
        jest.posterior = jax.jit(lambda x, y, get=get: JPAR.distributed_fit(
            jest.spec, x, y, mesh, get=get, block_size=BLOCK))(
                jnp.asarray(post.x_train), jnp.asarray(post.y_train))
        jest.mesh, jest.dist_block_size = mesh, BLOCK
        path = str(tmp_path_factory.mktemp("jax_ckpt") / get)
        jest.save(path)
        out[get] = (path, jest.predict(LINES))
    return out


@pytest.fixture(scope="module")
def runs(toy, jax_ckpts, tmp_path_factory):
    stats, qdir = toy
    pl = {"stats": [s.to_json() for s in stats], "qdir": qdir,
          "lines": LINES, "new": NEW, "b": BLOCK,
          "out": str(tmp_path_factory.mktemp("port_ckpt")),
          "jax_ckpt": {2: {g: jax_ckpts[g][0] for g in jax_ckpts}}}
    return pl, {p: on_ranks(p, "estimator", pl) for p in WORLDS}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_distributed_estimator_matches_jax(runs, jax_estimators, p, get):
    """Fit, predict (a repeated line served from the memo) and an online
    extend on the distributed tier, every rank the same."""
    _, res = runs
    want = jax_estimators[get]
    quantum = p * BLOCK
    for r in res[p]:
        got = r[get]
        kind, n_train, n_pad, b = got["layout"]
        assert (kind, n_train, b) == ("DistributedPosterior", 60, BLOCK)
        assert n_pad == quantum * -(-60 // quantum)
        mean, std = got["predict"]
        assert mean[0] == mean[4] and std[0] == std[4]
        _close(got["predict"], want["predict"], TOL[get])
        assert got["extended_train"] == 67
        _close(got["extended"], want["extended"], TOL[get])
        # a checkpoint written over the mesh restores over it
        _close(got["restored"], got["extended"], 1e-12)
        assert got["restored_layout"] == (BLOCK, 67)


@pytest.mark.parametrize("p,get", [(1, "nngp"), (2, "nngp"), (4, "nngp"),
                                   (2, "ntk")])
def test_port_checkpoint_restores_in_jax(runs, p, get):
    pl, res = runs
    path = os.path.join(pl["out"], f"{get}-p{p}")
    jest = JaxEstimator.restore(path, mesh=JPAR.make_mesh(p))
    assert jest.posterior.num_train == 67
    _close(jest.predict(LINES), res[p][0][get]["extended"], 1e-10)


@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_jax_checkpoint_restores_in_the_port(runs, jax_ckpts, get):
    _, res = runs
    for r in res[2]:
        _close(r[get]["from_jax"], jax_ckpts[get][1], 1e-10)


def test_restore_checks_the_mesh_size(runs):
    from nngp_tpu_torch.parallel import make_mesh
    from nngp_tpu_torch.serve import Estimator

    pl, _ = runs
    with pytest.raises(ValueError, match="fit on a 2-device mesh"):
        Estimator.restore(os.path.join(pl["out"], "nngp-p2"),
                          mesh=make_mesh(1, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="pass mesh="):
        Estimator.restore(os.path.join(pl["out"], "nngp-p1"), device="cpu")


def test_front_ends_serve_a_distributed_estimator_at_world_size_one(toy):
    import socket

    from nngp_tpu_torch.featurize.stats import TableStats
    from nngp_tpu_torch.parallel import make_mesh
    from nngp_tpu_torch.serve import (Estimator, EstimatorSocketServer,
                                      StreamingBatcher)

    stats, qdir = toy
    est = Estimator("toy", None, qdir,
                    stats=[TableStats.from_json(s.to_json()) for s in stats],
                    dtype=np.float64, verbose=False,
                    mesh=make_mesh(1, device="cpu"), device="cpu")
    assert type(est.posterior).__name__ == "DistributedPosterior"
    want = est.predict(LINES)
    with StreamingBatcher(est.predict) as batcher:
        got = batcher.predict(LINES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with EstimatorSocketServer(est) as srv:
        with socket.create_connection((srv.host, srv.port), timeout=30) as s:
            s.sendall((LINES[0] + "\n").encode())
            reply = s.makefile().readline()
    assert abs(float(reply.split('"mean": ')[1].split(",")[0])
               - want[0][0]) < 1e-9


@pytest.fixture(scope="module")
def learn_runs(toy, tmp_path_factory):
    stats, qdir = toy
    pl = {"stats": [s.to_json() for s in stats], "qdir": qdir,
          "lines": LINES, "new": NEW,
          "out": str(tmp_path_factory.mktemp("learn_ckpt"))}
    return {p: on_ranks(p, "estimator_learn", pl) for p in WORLDS}


def _same(got, want, p, tol):
    """Bit for bit at one rank (the collectives are identities), else to
    `tol` of the largest value (sums over ranks in another order)."""
    if p == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < tol


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("key", ["nystrom", "dtc_learn"])
def test_estimator_nystrom_tier_over_a_mesh(learn_runs, p, key):
    """Estimator(nystrom_m=, mesh=): moments streamed over the mesh, with
    and without a DTC learn (learn_hyper, its rows sharded over the mesh),
    predict and extend_with_lines as without the mesh; a checkpoint
    restored over the mesh reattaches it for the next extend."""
    for r in learn_runs[p]:
        got, want = r[key]["mesh"], r[key]["plain"]
        _same(got["spec"], want["spec"], p, 1e-9)
        _same(got["diag_reg"], want["diag_reg"], p, 1e-9)
        for a, b in zip(got["predict"] + got["extended"],
                        want["predict"] + want["extended"]):
            _same(a, b, p, 1e-9)
        assert got["restored_mesh"]
        for a, b in zip(*got["restored_extend"]):
            np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("p", WORLDS)
def test_relearn_on_the_distributed_tier_matches_the_exact_tier(learn_runs,
                                                                p):
    """relearn_hyperparams on the distributed tier relearns on its rows,
    gathered in natural order, and refits: the evidence and the ridge are
    the exact tier's (the same rows and loss), the predictions too."""
    for r in learn_runs[p]:
        got, want = r["relearn"]["mesh"], r["relearn"]["plain"]
        np.testing.assert_allclose(got["evidence"], want["evidence"],
                                   rtol=1e-12)
        assert got["diag_reg"] == want["diag_reg"]
        for a, b in zip(got["predict"], want["predict"]):
            assert _rel(a, b) < 1e-9
