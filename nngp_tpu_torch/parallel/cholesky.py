"""Distributed block-cyclic Cholesky and triangular solves over a mesh
(PyTorch counterpart of `nngp_tpu/parallel/cholesky.py`).

The Gram stays row-sharded end to end, so n is bounded by p devices'
memory, not one device's.

Layout, as in the JAX module: the n rows are split into nb = n / b panels
of width b. Panel g is owned by rank g % p and stored at its local slot
g // p, so every rank keeps working until the last panel. A rank's shard is
its nb / p panels stacked in slot order; globally that is the row
permutation `cyclic_storage_order(n, b, p)`: storage row s on rank
d = s // (n / p), local offset r = s % (n / p), holds elimination row
e(s) = (d + p (r // b)) b + r % b. Columns stay in elimination order, full
width. With b = n / p the permutation is the identity (contiguous row
blocks).

SPMD, not single controller: every function here is collective. Every rank
calls it with its own shard (the (n / p, n) factor or Gram rows, the
(n / p, r) right-hand-side rows, all in storage order) and gets its own
shard back. The JAX module's "psum of the owner's masked block" is
`dist.broadcast` from the owner (the same values, 1 / p of the bytes), its
`all_gather` is `all_gather_into_tensor`, and a Python loop over panels
replaces `lax.fori_loop` (nothing is compiled per panel here).

Factor: the two-level right-looking schedule of `_chol_local`: groups of p
panels; per panel the owner broadcasts its (b, b) diagonal block, every
rank factors it redundantly, solves its own panel rows below it, and the
masked panel rows are all-gathered and reordered slot -> elimination for
the trailing update. The port works in place, in one (n / p, n) buffer:
the JAX module's shrinking working set plus strip reassembly exists
because its arrays are immutable. The trailing update touches only the
rows below the panel and the columns right of it (the JAX module updates
the whole active block, where the masked rows and columns add zeros), and
the strict upper triangle (elimination coordinates) is cleared at the end.
A failed diagonal factor (a Gram that is not positive definite) raises
`torch.linalg.LinAlgError` on every rank; the JAX factor comes out NaN.

The per-panel factor, solves and updates are `torch.linalg` and
`torch.matmul` calls (cuSOLVER / cuBLAS on a card), as they are XLA ops in
the JAX module: this file holds no kernel.
"""

import numpy as np
import torch

from nngp_tpu_torch.parallel.mesh import (all_gather_rows, owner_broadcast,
                                          topology)


def cyclic_storage_order(n: int, block_size: int, p: int) -> np.ndarray:
    """g2e: storage index -> elimination index, so A_storage = A[g2e, :].

    Identity when block_size == n // p (one panel per device)."""
    b = block_size
    nb = n // b
    nbl = nb // p
    blocks = np.arange(p)[:, None] + p * np.arange(nbl)[None, :]  # (p, nbl)
    g2e = (blocks[:, :, None] * b + np.arange(b)).reshape(-1)
    return g2e


def _layout(n: int, p: int, block_size):
    b = n // p if block_size is None else int(block_size)
    if n % p:
        raise ValueError(f"n={n} not divisible by mesh size {p}")
    if b < 1 or n % b or (n // b) % p:
        raise ValueError(
            f"block_size={b} must tile n={n} into a multiple of p={p} panels")
    return b, n // b, n // p


def distributed_fit_cost(n: int, p: int, block_size=None, itemsize: int = 4):
    """The JAX module's analytic per-device cost of its schedule, copied
    unchanged (its tests assert its properties; the port's in-place update
    skips the masked rows and columns, so it does at most this much).

    The trailing update at group g is p rectangular matmuls of shape
    (m - g*b, b) x (b, n - g*p*b), so per-device update flops are
      sum_g p * 2 * (m - g*b) * (n - g*p*b) * b  ->  2 n^3 / (3 p)
    as ngrp = n/(p*b) grows: 2x the symmetric-half minimum n^3/(3p).
    Comm is the per-panel all_gather of the (ma, b) panel shard:
    Theta(n^2) bytes per device, independent of p."""
    b = n // p if block_size is None else int(block_size)
    nb = n // b
    ngrp = nb // p
    m = n // p
    flops_update = 0
    comm_bytes = 0
    for g in range(ngrp):
        ma = m - g * b
        na = n - g * p * b
        flops_update += p * 2 * ma * na * b            # p panels per group
        comm_bytes += p * (p - 1) * ma * b * itemsize  # all_gather receive
    # redundant diagonal factor (every device) + own row-panel solve
    flops_panel = nb * (b ** 3 // 3 + 2 * m * b * b)
    return {
        "flops_per_device": flops_update + flops_panel,
        "comm_bytes_per_device": comm_bytes,
        "flops_minimal_per_device": n ** 3 / (3 * p),
    }


# ------------------------------------------------------------------ factor
def _check_shard(a, m, n, name):
    if a.dim() != 2 or a.shape != (m, n):
        raise ValueError(f"{name} must be this rank's ({m}, {n}) storage "
                         f"rows, got {tuple(a.shape)}")


def _factor_in_place(a, group, p, d, b, nb, m):
    """Cholesky of the row-sharded matrix whose local rows are `a`
    (storage order, columns in elimination order), overwriting `a`."""
    n = nb * b
    failed = torch.zeros((), dtype=torch.bool, device=a.device)
    for g in range(nb // p):
        r0, c0 = g * b, g * p * b            # active local rows / columns
        for j in range(p):                   # panel j of the group, owner j
            col = c0 + j * b
            diag = owner_broadcast(lambda: a[r0:r0 + b, col:col + b], j,
                                   (b, b), a, group)
            lkk, info = torch.linalg.cholesky_ex(diag)
            failed |= info != 0
            # my active rows strictly below the panel's diagonal block: the
            # first row block only if its elimination block d follows j
            s = r0 if d > j else r0 + b
            if s < m:
                # L_ik = A_ik L_kk^-T
                a[s:, col:col + b] = torch.linalg.solve_triangular(
                    lkk.mT, a[s:, col:col + b], upper=True, left=False)
            if d == j:
                a[r0:r0 + b, col:col + b] = lkk
            if col + b == n:          # the last panel: no trailing columns
                continue
            mine = a[r0:, col:col + b].clone()
            if d <= j:
                mine[:b] = 0.0
            gathered = all_gather_rows(mine, group)          # (p ma, b)
            ma = m - r0
            # slot-major -> elimination-major over the active rows [c0, n)
            panel = (gathered.reshape(p, ma // b, b, b).transpose(0, 1)
                     .reshape(p * ma, b))
            if s < m:
                a[s:, col + b:].addmm_(a[s:, col:col + b],
                                       panel[col + b - c0:].mT, alpha=-1.0)
    # strict upper triangle in elimination coordinates
    for t in range(m // b):
        e = d + p * t
        rows = slice(t * b, (t + 1) * b)
        a[rows, (e + 1) * b:] = 0.0
        a[rows, e * b:(e + 1) * b] = torch.tril(a[rows, e * b:(e + 1) * b])
    if bool(failed):
        raise torch.linalg.LinAlgError(
            "distributed_cholesky: a diagonal block is not positive "
            "definite (the Gram is not SPD)")
    return a


def distributed_cholesky(k_local: torch.Tensor, mesh, axis_name: str = "data",
                         block_size=None, overwrite: bool = False):
    """Cholesky of a row-sharded SPD matrix: this rank's (n / p, n) rows in
    storage order in, this rank's rows of L out. Collective.

    With block_size=None the rows are plain contiguous blocks (one panel per
    rank). With block_size=b < n/p the rows must be in block-cyclic storage
    order (`cyclic_storage_order(n, b, p)`, columns in elimination order)
    and L comes back in that order. overwrite=True factors in k_local's own
    memory (the fit's way: no second shard)."""
    group, p, d = topology(mesh, axis_name)
    n = k_local.shape[-1]
    b, nb, m = _layout(n, p, block_size)
    _check_shard(k_local, m, n, "k_local")
    a = k_local if overwrite else k_local.clone()
    return _factor_in_place(a, group, p, d, b, nb, m)


# ------------------------------------------------------------------ solves
def _fwd(l_loc, rhs, group, p, d, b, nb, m):
    y = rhs.clone()
    x = torch.zeros_like(rhs)
    r = rhs.shape[1]
    for kb in range(nb):
        owner, slot = kb % p, (kb // p) * b
        cols = slice(kb * b, (kb + 1) * b)
        # two broadcasts, not one packed buffer: at b = n / p the diagonal
        # block is a whole shard, and packing would copy it
        lkk = owner_broadcast(lambda: l_loc[slot:slot + b, cols].to(
            y.dtype), owner, (b, b), y, group)
        yk = owner_broadcast(lambda: y[slot:slot + b], owner, (b, r), y,
                             group)
        xk = torch.linalg.solve_triangular(lkk, yk, upper=False)
        if d == owner:
            x[slot:slot + b] = xk
        # my rows below panel kb (elimination block > kb): a suffix
        s0 = ((kb - d) // p + 1) * b
        if s0 < m:
            y[s0:].addmm_(l_loc[s0:, cols].to(y.dtype), xk, alpha=-1.0)
    return x


def _bwd(l_loc, rhs, group, p, d, b, nb, m):
    y = rhs.clone()
    x = torch.zeros_like(rhs)
    n, r = nb * b, rhs.shape[1]
    nbl = m // b
    for kb in range(nb - 1, -1, -1):
        owner, slot = kb % p, (kb // p) * b
        # the owner's full row panel L[kb-block, :] and its rhs rows
        rowpan = owner_broadcast(lambda: l_loc[slot:slot + b].to(y.dtype),
                                 owner, (b, n), y, group)
        yk = owner_broadcast(lambda: y[slot:slot + b], owner, (b, r), y,
                             group)
        xk = torch.linalg.solve_triangular(
            rowpan[:, kb * b:(kb + 1) * b].mT, yk, upper=True)
        if d == owner:
            x[slot:slot + b] = xk
        # my rows above panel kb (elimination block < kb): a prefix; their
        # columns of the row panel, in my local order
        s1 = max(0, -((d - kb) // p))
        if s1:
            sel = rowpan.reshape(b, nbl, p, b)[:, :s1, d, :].reshape(
                b, s1 * b)
            y[:s1 * b].addmm_(sel.mT, xk, alpha=-1.0)
    return x


def _solve(body, l_local, rhs_local, mesh, axis_name, block_size):
    group, p, d = topology(mesh, axis_name)
    n = l_local.shape[-1]
    b, nb, m = _layout(n, p, block_size)
    _check_shard(l_local, m, n, "l_local")
    if rhs_local.dim() != 2 or rhs_local.shape[0] != m:
        raise ValueError(f"the right-hand side must be this rank's ({m}, r) "
                         f"storage rows, got {tuple(rhs_local.shape)}")
    return body(l_local, rhs_local, group, p, d, b, nb, m)


def distributed_tri_solve_lower(l_local, b_local, mesh,
                                axis_name: str = "data", block_size=None):
    """Solve L x = b with L and b row-sharded in the same storage order;
    returns this rank's rows of x. Collective. A b of a wider dtype than
    L's (fp64 against fp32) is solved in b's, L's panels converted as they
    are used."""
    return _solve(_fwd, l_local, b_local, mesh, axis_name, block_size)


def distributed_tri_solve_lower_t(l_local, b_local, mesh,
                                  axis_name: str = "data", block_size=None):
    """Solve L^T x = b (backward substitution), everything row-sharded.
    Collective."""
    return _solve(_bwd, l_local, b_local, mesh, axis_name, block_size)


def distributed_cho_solve(l_local, b_local, mesh, axis_name: str = "data",
                          block_size=None):
    """(L L^T)^-1 b by a forward then a backward solve, fully sharded.
    Collective."""
    y = distributed_tri_solve_lower(l_local, b_local, mesh, axis_name,
                                    block_size)
    return distributed_tri_solve_lower_t(l_local, y, mesh, axis_name,
                                         block_size)
