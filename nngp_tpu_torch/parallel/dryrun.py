"""Multi-rank dry run of the distributed tier on CPU ranks.

    python -m nngp_tpu_torch.parallel.dryrun 4 [--n 1000] [--block_size 16]

The port's counterpart of `__graft_entry__.dryrun_multichip(n)`: it spawns
N gloo ranks on this machine's CPU (a free localhost port, no launcher),
and every rank runs one training step (its rows of the sharded Gram ->
the block-cyclic distributed Cholesky -> alpha) with a predict on the
row-sharded posterior, then `sharded_fit` and the test-row-sharded
`sharded_predict_mean_std`. Each rank holds its results against a plain
single-process fit of the same seeded data (the generic-diagonal Gram of
`models.kernel_spec.kernel_eval`, `torch.linalg.cholesky`). Rank 0 prints
one JSON line. The exit code is non-zero when any rank fails: a check, an
exception, or a collective that times out (`parallel.mesh`'s group
timeout).
"""

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

# relative agreement with the plain fit (fp64, n ~ 1e3: the two factor the
# same matrix in other orders)
_TOL = 1e-8


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _plain(spec, x, y, x_test, diag_reg=1e-3):
    """(alpha, mean, std) of one process: the generic-diagonal Gram plus
    the relative ridge, a dense Cholesky."""
    from nngp_tpu_torch.models.kernel_spec import (apply_diag_recursion,
                                                   diag_eval, kernel_eval)
    from nngp_tpu_torch.ops.gram import input_diag

    x, y, x_test = (torch.as_tensor(a) for a in (x, y, x_test))
    dn, _ = apply_diag_recursion(input_diag(x), spec.layers)
    k = kernel_eval(spec.layers, x, x, "nngp")
    k.diagonal().add_(diag_reg * torch.mean(dn))
    l = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(y, l)
    cross = kernel_eval(spec.layers, x_test, x, "nngp")
    v = torch.linalg.solve_triangular(l, cross.mT, upper=False)
    var = diag_eval(spec.layers, x_test, "nngp") - torch.sum(v * v, dim=0)
    return alpha, cross @ alpha, torch.sqrt(torch.clamp_min(var, 0.0))


def _rank(rank: int, world: int, port: int, n: int, block_size: int,
          seed: int):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from nngp_tpu_torch.models.kernel_spec import reference_kernel
    from nngp_tpu_torch.parallel import (distributed_fit, make_mesh,
                                         sharded_fit,
                                         sharded_predict_mean_std)

    mesh = make_mesh(world, device="cpu")
    rng = np.random.default_rng(seed)
    d, n_test = 16, 8 * world
    x = rng.uniform(0.0, 1000.0, (n, d))
    y = rng.standard_normal((n, 1))
    x_test = rng.uniform(0.0, 1000.0, (n_test, d))
    spec = reference_kernel()
    alpha, mean, std = _plain(spec, x, y, x_test)

    t0 = time.perf_counter()
    post = distributed_fit(spec, x, y, mesh, block_size=block_size)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_d, s_d = post.predict_mean_std(x_test)
    predict_s = time.perf_counter() - t0
    n_sh = n - n % world                     # sharded_fit needs n % p == 0
    l, a_s, _ = sharded_fit(spec, x[:n_sh], y[:n_sh], mesh)
    m_s, s_s = sharded_predict_mean_std(spec, x_test, x[:n_sh], l, a_s, mesh)
    _, mean_sh, std_sh = _plain(spec, x[:n_sh], y[:n_sh], x_test)
    errs = {"alpha": _rel(post.alpha_natural(), alpha),
            "mean": _rel(m_d, mean), "std": _rel(s_d, std),
            "sharded_mean": _rel(m_s, mean_sh),
            "sharded_std": _rel(s_s, std_sh)}
    bad = {k: v for k, v in errs.items() if not v <= _TOL}
    if bad:
        raise AssertionError(f"rank {rank}: off the plain fit by {bad} "
                             f"(bound {_TOL})")
    if rank == 0:
        print(json.dumps({"world": world, "n": n, "n_padded":
                          post.num_padded, "block_size": post.block_size,
                          "fit_s": fit_s, "predict_s": predict_s,
                          "max_rel_err": max(errs.values())}), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("nngp_tpu_torch.parallel.dryrun")
    p.add_argument("world", type=int, help="number of gloo CPU ranks")
    p.add_argument("--n", type=int, default=1000,
                   help="training rows (ragged: padded to the layout)")
    p.add_argument("--block_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.world < 1:
        p.error("world must be >= 1")
    import torch.multiprocessing as mp

    # raises (and ends the other ranks) when any rank fails
    mp.spawn(_rank, args=(args.world, _free_port(), args.n, args.block_size,
                          args.seed), nprocs=args.world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
