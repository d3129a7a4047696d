"""The port's multi-device linear algebra (`nngp_tpu_torch.parallel`)
against the JAX package's, at p = 1, 2 and 4 ranks, fp64 on the CPU.

JAX runs its mesh of p of the 8 virtual CPU devices (tests/conftest.py) in
this process, each call under `jax.jit` (an eager shard_map of the kernel
recursion takes ~15 s here, the jitted one well under 1 s); the port runs
p gloo ranks (`tests/torch_parallel_cases.py`:
p = 1 in this process on a HashStore group, p > 1 spawned once per p for
the whole file). Results come back as each rank's shard, in storage order.

Tolerances (max |port - ref| / max |ref|):
  - factor, solves, sharded Grams and fits on fixed SPD / integer inputs:
    1e-10 against JAX and numpy (the same products summed in other
    orders);
  - the generic-diagonal pin: the distributed Gram's diagonal equals
    `gram_cross`'s own value (1e-13) and JAX's (1e-8: each package rounds
    cos t = k12 / sqrt(k11 k22) at rho = 1 its own way, ~sqrt(eps) in the
    NTK dual, ROADMAP Queue C), and for the NTK it is not the exact
    diagonal that `gram_sym` writes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nngp_tpu.parallel as JPAR
import nngp_tpu.parallel.cholesky as JCH
from nngp_tpu.parallel.sharded import _gram_storage as jax_gram_storage
from nngp_tpu_torch.models.kernel_spec import diag_eval, reference_kernel
from nngp_tpu_torch.ops.gram_cuda import gram_cross_plain
from nngp_tpu_torch.parallel import cholesky as TCH
from tests.test_torch_common import jax_spec
from tests.torch_parallel_cases import on_ranks

WORLDS = (1, 2, 4)
N = 64


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _whole(shards):
    """The ranks' row shards stacked back into the whole array."""
    return np.concatenate([np.asarray(s) for s in shards])


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _blocks(p):
    return (N // p, N // (4 * p))     # contiguous, and cyclic (4 groups)


@pytest.fixture(scope="module")
def linalg():
    k = _spd(N, seed=5)
    rhs = np.random.default_rng(6).standard_normal((N, 3))
    out = {}
    for p in WORLDS:
        ranks = on_ranks(p, "linalg", {"k": k, "rhs": rhs,
                                       "blocks": _blocks(p)})
        out[p] = {b: {key: (_whole([r[b][key] for r in ranks])
                            if key != "k_untouched"
                            else all(r[b][key] for r in ranks))
                      for key in ranks[0][b]} for b in _blocks(p)}
    return k, rhs, out


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("which", ["contiguous", "cyclic"])
def test_factor_and_solves_match_numpy(linalg, p, which):
    k, rhs, out = linalg
    b = _blocks(p)[which == "cyclic"]
    g2e = TCH.cyclic_storage_order(N, b, p)
    if which == "contiguous":
        np.testing.assert_array_equal(g2e, np.arange(N))
    got = out[p][b]
    assert got["k_untouched"]
    l = np.linalg.cholesky(k)
    assert _rel(got["l"], l[g2e]) < 1e-12
    assert _rel(got["fwd"], np.linalg.solve(l, rhs)[g2e]) < 1e-10
    assert _rel(got["bwd"], np.linalg.solve(l.T, rhs)[g2e]) < 1e-10
    assert _rel(got["cho"], np.linalg.solve(k, rhs)[g2e]) < 1e-10


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("which", ["contiguous", "cyclic"])
def test_factor_and_solves_match_jax(linalg, p, which):
    k, rhs, out = linalg
    b = _blocks(p)[which == "cyclic"]
    g2e = JCH.cyclic_storage_order(N, b, p)
    np.testing.assert_array_equal(g2e, TCH.cyclic_storage_order(N, b, p))
    mesh = JPAR.make_mesh(p)
    l = jax.jit(lambda a: JCH.distributed_cholesky(a, mesh, block_size=b))(
        jnp.asarray(k[g2e]))
    rs = jnp.asarray(rhs[g2e])
    got = out[p][b]
    assert _rel(got["l"], l) < 1e-12
    for key, fn in (("fwd", JCH.distributed_tri_solve_lower),
                    ("bwd", JCH.distributed_tri_solve_lower_t),
                    ("cho", JCH.distributed_cho_solve)):
        want = jax.jit(lambda a, r: fn(a, r, mesh, block_size=b))(l, rs)
        assert _rel(got[key], want) < 1e-10, key


@pytest.mark.parametrize("n,p,b", [(64, 1, None), (64, 4, 4), (256, 2, 32),
                                   (32768, 8, None), (32768, 8, 256),
                                   (65536, 16, 256), (1000, 5, 40)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_fit_cost_equals_jax(n, p, b, itemsize):
    assert (TCH.distributed_fit_cost(n, p, b, itemsize)
            == JCH.distributed_fit_cost(n, p, b, itemsize))


@pytest.mark.parametrize("n,p,b,match", [(30, 8, None, "not divisible"),
                                         (64, 8, 16, "block_size"),
                                         (64, 2, 0, "block_size")])
def test_layout_errors(n, p, b, match):
    with pytest.raises(ValueError, match=match):
        TCH._layout(n, p, b)
    if b != 0:                 # JAX divides by zero before it checks
        with pytest.raises(ValueError, match=match):
            JCH._layout(n, p, b)


def test_make_mesh_is_world_size_one_without_a_launcher():
    from nngp_tpu_torch.parallel import make_mesh
    from nngp_tpu_torch.parallel.mesh import mesh_device, mesh_rank

    mesh = make_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    assert mesh_rank(mesh) == 0 and mesh_device(mesh) == torch.device("cpu")
    assert make_mesh(1, device="cpu").size() == 1
    with pytest.raises(ValueError, match="world size is 1"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(1, device="cuda")


def test_shard_must_be_this_ranks_rows():
    from nngp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="storage rows"):
        TCH.distributed_cholesky(torch.eye(8)[:4], mesh)
    l = TCH.distributed_cholesky(torch.eye(8, dtype=torch.float64), mesh)
    with pytest.raises(ValueError, match="storage rows"):
        TCH.distributed_cho_solve(l, torch.ones(4, 1, dtype=l.dtype), mesh)
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    with pytest.raises(torch.linalg.LinAlgError, match="not positive"):
        TCH.distributed_cholesky(bad, mesh)


# ------------------------------------------------- sharded Grams and fits
@pytest.fixture(scope="module")
def sharded_runs():
    rng = np.random.default_rng(4)
    pl = {"spec": reference_kernel(),
          "x": rng.integers(0, 1000, (N, 12)).astype(np.float64),
          "y": rng.standard_normal((N, 1)),
          "xt": rng.integers(0, 1000, (16, 12)).astype(np.float64),
          "b": 4}
    return pl, {p: on_ranks(p, "sharded", pl) for p in WORLDS}


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_sharded_gram_matches_jax(sharded_runs, p, get):
    pl, runs = sharded_runs
    mesh, spec = JPAR.make_mesh(p), jax_spec(pl["spec"])
    want = jax.jit(lambda x: JPAR.sharded_gram(spec, x, mesh, get))(
        jnp.asarray(pl["x"]))
    got = _whole([r["gram"][get] for r in runs[p]])
    # ntk: the diagonal's generic NTK dual (acos at rho = 1) is rounded
    # differently by the two packages, ~1e-9 of the largest entry
    assert _rel(got, want) < (1e-10 if get == "nngp" else 1e-8)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("get", ["nngp", "ntk"])
def test_sharded_fit_and_predict_match_jax(sharded_runs, p, get):
    """Replicated fit (l, alpha, reg[, k_tt]) on every rank, and the
    test-row-sharded predict gathered on every rank."""
    pl, runs = sharded_runs
    mesh = JPAR.make_mesh(p)
    spec = jax_spec(pl["spec"])
    fit = jax.jit(lambda x, y: JPAR.sharded_fit(spec, x, y, mesh, get=get))(
        jnp.asarray(pl["x"]), jnp.asarray(pl["y"]))
    k_tt = fit[3] if get == "ntk" else None
    pred = jax.jit(lambda xt, x, l, a, k: JPAR.sharded_predict_mean_std(
        spec, xt, x, l, a, mesh, get=get, k_tt=k))(
        jnp.asarray(pl["xt"]), jnp.asarray(pl["x"]), fit[0], fit[1], k_tt)
    # ntk: the generic NTK diagonal (acos at rho = 1) differs by ~1e-9
    # between the packages and the solve amplifies it
    tol = 1e-10 if get == "nngp" else 1e-6
    for r in runs[p]:
        for got, want in zip(r[get]["fit"], fit):
            assert _rel(got, want) < tol
        for got, want in zip(r[get]["predict"], pred):
            assert _rel(np.ravel(got), np.ravel(want)) < tol


@pytest.mark.parametrize("p", WORLDS)
def test_distributed_gram_diagonal_is_the_generic_dual(sharded_runs, p):
    """The distributed fit factors a CROSS Gram of storage rows against
    natural rows (`_cross_block` in the JAX package): its diagonal is the
    generic dual's value at rho = 1, which for the NTK is not the exact
    diagonal `gram_sym` writes. Kept as the JAX package has it."""
    pl, runs = sharded_runs
    x = pl["x"]
    g2e = TCH.cyclic_storage_order(N, pl["b"], p)
    got = {k: _whole([r["pin"][k] for r in runs[p]])
           for k in ("nngp_diag", "ntk_diag")}
    xt = torch.as_tensor(x)
    generic = [np.diag(k.numpy())[g2e]
               for k in gram_cross_plain(pl["spec"], xt, xt, ("nngp", "ntk"))]
    exact = [d.numpy()[g2e]
             for d in diag_eval(pl["spec"].layers, xt, ("nngp", "ntk"))]
    assert _rel(got["nngp_diag"], generic[0]) < 1e-13
    assert _rel(got["ntk_diag"], generic[1]) < 1e-13
    assert _rel(got["ntk_diag"], exact[1]) > 1e-10
    # the JAX package's storage Gram, same layout
    reg = float(runs[p][0]["pin"]["reg"])
    mesh, spec = JPAR.make_mesh(p), jax_spec(pl["spec"])
    jk_tt, jsolve = jax.jit(lambda xs, xn, r: jax_gram_storage(
        spec, xs, xn, r, mesh, "data", pl["b"], True, N))(
        jnp.asarray(x[g2e]), jnp.asarray(x), jnp.asarray(reg))
    rows = np.arange(N)
    assert _rel(got["nngp_diag"], np.asarray(jk_tt)[rows, g2e]) < 1e-8
    assert _rel(got["ntk_diag"], np.asarray(jsolve)[rows, g2e] - reg) < 1e-8
