"""Mesh-sharded Gram assembly and GP fit / predict / extend (PyTorch
counterpart of `nngp_tpu/parallel/sharded.py`).

Layout, as in the JAX module:

  X_train  (n, d)   every rank holds the natural-order rows (n d is small)
                    and takes its own storage rows from them.
  K        (n, n)   row-block sharded: each rank computes its (n/p, n) rows
                    with `gram_cross` (the CUDA kernel on a card). The
                    O(n^2) object is never replicated.
  Cholesky          `sharded_fit` gathers the sharded Gram and factors it
                    on every rank (the JAX module leaves that gather to
                    XLA's partitioner: fine while n^2 fits one device);
                    `distributed_fit` keeps it row-sharded through the
                    block-cyclic factor and solves of `parallel/cholesky.py`.
  predict           `sharded_predict_mean_std` shards the TEST rows (factor
                    replicated); `DistributedPosterior.predict_mean_std`
                    shards the cross Gram over TRAIN rows, so no rank holds
                    an O(n^2) object.

SPMD: every public function and method is collective. Every rank calls it
with the same arguments (host numpy inputs or tensors, the same spec) and
gets the same replicated result back (mean, std, covariance, evidence);
the O(n^2) state stays in each rank's shard. A contraction over the n
axis is a local product followed by `all_reduce(SUM)`.

The distributed Gram is a CROSS Gram of a rank's storage rows against all
natural rows (`_cross_block` in the JAX module), so its diagonal carries
the generic dual's value at rho = 1, not the exact diagonal that
`gram_sym` writes. That is the JAX package's semantics and is kept
(tests pin it); the single-device exact tier writes the exact diagonal.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from nngp_tpu_torch.gp.posterior import (_auto_input_scale, _mm_wide,
                                         needs_raw_fp64, raw_fp64)
from nngp_tpu_torch.models.kernel_spec import (KernelSpec,
                                               apply_diag_recursion)
from nngp_tpu_torch.ops.gram import input_diag
from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym
from nngp_tpu_torch.parallel.cholesky import (cyclic_storage_order,
                                              distributed_cho_solve,
                                              distributed_cholesky,
                                              distributed_tri_solve_lower)
from nngp_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_sum,
                                          gather_rows_to_host, mesh_device,
                                          topology)


def _to_mesh(a, device, dtype=None) -> torch.Tensor:
    """numpy or tensor -> contiguous tensor on this rank's device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=device).contiguous()


def _elim_rows(d: int, m: int, b: int, p: int, device) -> torch.Tensor:
    """Elimination index of each of rank d's m storage rows."""
    r = torch.arange(m, device=device)
    return (d + p * (r // b)) * b + r % b


def _gets(want_pair):
    return ("nngp", "ntk") if want_pair else "nngp"


def sharded_gram(spec: KernelSpec, x, mesh, get="nngp",
                 axis_name: str = "data"):
    """Row-block-sharded Gram of the (n, d) rows x: this rank's (n / p, n)
    rows (a tuple of them for a tuple `get`), from its contiguous row block
    against all of x. Collective: every rank passes the same x."""
    group, p, d = topology(mesh, axis_name)
    x = _to_mesh(x, mesh_device(mesh))
    n = x.shape[0]
    if n % p:
        raise ValueError(f"n={n} not divisible by mesh size {p}")
    m = n // p
    return gram_cross(spec, x[d * m:(d + 1) * m].contiguous(), x, get)


def _gram_storage(spec, x_local, x_natural, reg, p, d, b, want_pair, n_real):
    """This rank's rows of the kernel Gram in block-cyclic storage order,
    with the relative ridge on the (elimination) diagonal, edited in place:
    the unridged Gram never exists beside it.

    Rows and columns beyond elimination index n_real are inert padding:
    zeroed, with exactly 1 on their diagonal, so the padded Gram is
    block-diag(K_real + r I, I). Returns the solve Gram, or (NNGP Gram,
    solve Gram) when want_pair."""
    grams = gram_cross(spec, x_local, x_natural, _gets(want_pair))
    grams = grams if want_pair else (grams,)
    m = x_local.shape[0]
    e_row = _elim_rows(d, m, b, p, x_local.device)
    pad = torch.nonzero(e_row >= n_real).reshape(-1)
    for k in grams:
        k[:, n_real:] = 0.0
        k.index_fill_(0, pad, 0.0)
    solve = grams[-1]
    ridge = torch.where(e_row < n_real, reg.to(solve.dtype),
                        solve.new_ones(()))
    solve.index_put_((torch.arange(m, device=solve.device), e_row), ridge,
                     accumulate=True)
    return grams if want_pair else solve


def _ridge(x_real, layers, get, diag_reg):
    """diag_reg times the mean exact solve-kernel diagonal over the real
    rows (the O(n) recursion; padding never shifts it)."""
    dn, dt = apply_diag_recursion(input_diag(x_real), layers)
    return (diag_reg * torch.mean(dn if get == "nngp" else dt)).to(
        x_real.dtype)


def sharded_fit(spec: KernelSpec, x, y, mesh, diag_reg: float = 1e-3,
                get: str = "nngp", axis_name: str = "data"):
    """Sharded Gram -> gathered factor -> alpha, replicated on every rank:
    (l, alpha, reg), plus the NNGP Gram k_tt for get='ntk'. The Gram's rows
    are computed sharded and gathered for the factorization, as XLA's
    partitioner gathers them in the JAX module; use `distributed_fit` when
    n^2 exceeds one device. Collective."""
    if get not in ("nngp", "ntk"):
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    group, _, _ = topology(mesh, axis_name)
    dev = mesh_device(mesh)
    x = _to_mesh(x, dev)
    y = _to_mesh(y, dev, x.dtype)
    if y.dim() == 1:
        y = y[:, None]
    rows = sharded_gram(spec, x, mesh, _gets(get == "ntk"), axis_name)
    rows = rows if get == "ntk" else (rows,)
    full = [all_gather_rows(r, group) for r in rows]
    solve_k = full[-1]
    reg = _ridge(x, spec.layers, get, diag_reg)
    solve_k.diagonal().add_(reg)
    l = torch.linalg.cholesky(solve_k)
    alpha = torch.cholesky_solve(y, l)
    if get == "ntk":
        return l, alpha, reg, full[0]
    return l, alpha, reg


def sharded_predict_mean_std(spec: KernelSpec, x_test, x_train, l, alpha,
                             mesh, axis_name: str = "data",
                             get: str = "nngp", k_tt=None):
    """Batched posterior (mean (te, 1), std (te,)) with the TEST rows
    sharded over the mesh and the factor replicated (the serving fan-out
    while the factor fits one device). For get='ntk' pass the train NNGP
    Gram as k_tt. Every rank gets the whole (gathered) result.
    Collective."""
    if get == "ntk" and k_tt is None:
        raise ValueError("get='ntk' needs the train NNGP Gram (k_tt)")
    group, p, d = topology(mesh, axis_name)
    dev = mesh_device(mesh)
    x_tr = _to_mesh(x_train, dev)
    x_te = _to_mesh(x_test, dev, x_tr.dtype)
    l, alpha = _to_mesh(l, dev), _to_mesh(alpha, dev)
    te = x_te.shape[0]
    if te % p:
        raise ValueError(f"{te} test rows not divisible by mesh size {p}")
    t = te // p
    x_loc = x_te[d * t:(d + 1) * t].contiguous()
    nngp_c, ntk_c = gram_cross(spec, x_loc, x_tr, ("nngp", "ntk"))
    diag_ss, _ = apply_diag_recursion(input_diag(x_loc), spec.layers)
    if get == "nngp":
        mean = nngp_c @ alpha
        v = torch.linalg.solve_triangular(l, nngp_c.mT, upper=False)
        var = diag_ss - torch.sum(v * v, dim=0)
    else:
        mean = ntk_c @ alpha
        w = torch.cholesky_solve(ntk_c.mT, l)
        kw = _to_mesh(k_tt, dev) @ w
        var = (diag_ss + torch.sum(w * kw, dim=0)
               - 2.0 * torch.sum(nngp_c.mT * w, dim=0))
    std = torch.sqrt(torch.clamp_min(var, 0.0))
    return all_gather_rows(mean, group), all_gather_rows(std, group)


@dataclasses.dataclass(eq=False)
class DistributedPosterior:
    """GP posterior whose O(n^2) state (factor, train NNGP Gram) stays
    row-sharded over the mesh in block-cyclic storage order: each rank
    holds its own (n / p, .) rows of x_storage, y_storage, l, alpha and
    k_tt, and the mesh. Every method is collective.

    Storage row s holds elimination (natural) row g2e[s]; columns of l and
    k_tt are in natural order. alpha is in storage order: `alpha_natural()`
    gives the plain vector. Elimination rows >= n_real are inert padding
    (the padded Gram is block-diag(K_real + r I, I), pad labels and alphas
    are 0, pad cross rows are masked to 0), so any training-set size fits
    the p * block_size layout quantum with the unpadded posterior's
    semantics."""

    x_storage: torch.Tensor          # (n/p, d) my storage rows, prescaled
    y_storage: torch.Tensor          # (n/p, 1)
    l: torch.Tensor                  # (n/p, n) my rows of the cyclic factor
    alpha: torch.Tensor              # (n/p, 1) storage order
    reg: torch.Tensor                # scalar ridge actually added
    k_tt: Optional[torch.Tensor]     # (n/p, n) NNGP Gram rows (ntk only)
    spec: KernelSpec
    get: str
    mesh: object
    axis_name: str
    block_size: int
    g2e: np.ndarray                  # (n,) storage -> elimination index
    n_real: int                      # real (unpadded) train rows
    # power-of-two input prescale: x_storage is stored divided by it,
    # incoming x divides on entry, reported std multiplies back
    input_scale: float = 1.0

    @property
    def num_train(self) -> int:
        """Real training rows (inert layout padding excluded)."""
        return self.n_real

    @property
    def num_padded(self) -> int:
        """Storage rows including inert padding (= factor dimension)."""
        return int(self.g2e.shape[0])

    @property
    def device(self) -> torch.device:
        return self.x_storage.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x_storage.dtype

    @property
    def _group(self):
        return self.mesh.get_group(self.axis_name)

    def _coords(self):
        _, p, d = topology(self.mesh, self.axis_name)
        return p, d

    def _live_rows(self, n_real=None):
        """(m,) bool: my storage rows that are real (elimination < n_real)."""
        p, d = self._coords()
        e = _elim_rows(d, self.x_storage.shape[0], self.block_size, p,
                       self.device)
        return e < (self.n_real if n_real is None else n_real)

    # ------------------------------------------------ natural-order views
    def _e2s(self) -> torch.Tensor:
        cached = getattr(self, "_e2s_cache", None)
        if cached is None:
            cached = torch.as_tensor(np.argsort(self.g2e), device=self.device)
            self._e2s_cache = cached
        return cached

    def _unpermute(self, local):
        """My storage rows of a row-sharded array -> the whole array in
        natural order, real rows only (replicated)."""
        full = all_gather_rows(local, self._group)
        return full[self._e2s()][:self.num_train]

    def alpha_natural(self) -> torch.Tensor:
        """alpha in natural train-row order, real rows only."""
        return self._unpermute(self.alpha)

    def x_natural(self) -> torch.Tensor:
        """The prescaled training rows in natural order."""
        return self._unpermute(self.x_storage)

    def y_natural(self) -> torch.Tensor:
        return self._unpermute(self.y_storage)

    def gather_state(self) -> Optional[dict]:
        """Every sharded array gathered into rank 0's host memory, in
        storage order (numpy), with the ridge: the arrays of the JAX
        package's distributed checkpoint. None on the other ranks. No
        device holds a whole (n, n) array, as in the JAX package, which
        gathers into host memory too."""
        out = {"x_storage": self.x_storage, "y_storage": self.y_storage,
               "l": self.l, "alpha": self.alpha}
        if self.k_tt is not None:
            out["k_tt"] = self.k_tt
        out = {k: gather_rows_to_host(v, self._group) for k, v in out.items()}
        if self._coords()[1] != 0:
            return None
        out["reg"] = self.reg.cpu().numpy()
        return out

    def is_finite(self) -> bool:
        """alpha and the factor's pivots finite on every rank."""
        p, d = self._coords()
        m = self.l.shape[0]
        piv = self.l[torch.arange(m, device=self.device),
                     _elim_rows(d, m, self.block_size, p, self.device)]
        bad = (~torch.isfinite(self.alpha)).sum() + (~torch.isfinite(piv)).sum()
        return int(all_reduce_sum(bad, self._group)) == 0

    # ---------------------------------------------------------- evidence
    def log_marginal_likelihood(self) -> float:
        """Exact GP log evidence in raw units, as
        `GPPosterior.log_marginal_likelihood`, from the sharded factor:
        pivots live at l[s, g2e[s]]; inert pad rows have pivot 1, alpha 0
        and y 0, so they add nothing."""
        p, d = self._coords()
        m = self.l.shape[0]
        piv = self.l[torch.arange(m, device=self.device),
                     _elim_rows(d, m, self.block_size, p, self.device)]
        parts = torch.stack([torch.sum(self.y_storage * self.alpha),
                             2.0 * torch.sum(torch.log(piv))])
        quad, logdet = (float(v) for v in all_reduce_sum(parts, self._group))
        n = self.num_train
        if self.input_scale != 1.0:
            s2 = float(self.input_scale) ** 2
            quad /= s2
            logdet += n * np.log(s2)
        return -0.5 * (quad + logdet + n * np.log(2.0 * np.pi))

    # ----------------------------------------------------------- predict
    def _as_input(self, x):
        x = _to_mesh(x, self.device, self.dtype)
        if x.dim() != 2 or x.shape[1] != self.x_storage.shape[1]:
            raise ValueError(f"inputs must be (rows, {self.x_storage.shape[1]})"
                             f", got {tuple(x.shape)}")
        return x

    def _cross_grams(self, x_test, get):
        """Cross Grams of the test rows vs my storage rows, (te, n/p), pad
        columns masked to 0: the factor treats pad rows as an identity
        block, so unmasked pad entries would leak into the variance
        solves. Test rows lead, as in the single-device tier: the mean's
        fp32 dot then runs along contiguous rows (its transpose sums the
        same products with ~4x the rounding on the CPU)."""
        return self._mask_pad(gram_cross(self.spec, x_test, self.x_storage,
                                         get))

    def _mask_pad(self, out):
        """Zero the pad columns of a cross Gram (or a pair) in place."""
        pad = torch.nonzero(~self._live_rows()).reshape(-1)
        for k in (out if isinstance(out, tuple) else (out,)):
            k.index_fill_(1, pad, 0.0)
        return out


    def _predict_scaled(self, x_test, compute_cov):
        """Predict body on raw-unit x_test; var / cov come back divided by
        input_scale^2, as `GPPosterior._predict_scaled`. Every contraction
        over the n axis is a local product and an all-reduce; the (te, te)
        results are the only replicated buffers."""
        x_raw = self._as_input(x_test)
        x_test = x_raw
        if self.input_scale != 1.0:
            x_test = x_raw * (1.0 / self.input_scale)
        mesh, ax, bs, group = (self.mesh, self.axis_name, self.block_size,
                               self._group)
        layers, spec, dtype = self.spec.layers, self.spec, self.dtype
        wide = needs_raw_fp64(self.input_scale, dtype)

        def var_kernels(fn):
            """The kernels the variance reads; in fp64 on the raw rows for
            an fp32 prescale, as `GPPosterior._predict_scaled`."""
            if wide:
                return raw_fp64(fn, x_raw, self.x_storage, self.input_scale)
            return fn(x_test, self.x_storage)

        def k_diag(xs, _):
            return apply_diag_recursion(input_diag(xs), layers)[0]

        def k_ss(xs, _):
            return gram_sym(spec, xs, "nngp")            # exact diagonal

        if self.get == "nngp":
            cross = self._cross_grams(x_test, "nngp")         # (te, n/p)
            mean = all_reduce_sum(cross @ self.alpha, group)
            if compute_cov is False:
                return mean
            if wide:
                cross = self._mask_pad(var_kernels(
                    lambda a, b: gram_cross(spec, a, b, "nngp")))
            rhs = cross.mT.contiguous()                       # (n/p, te)
            del cross
            v = distributed_tri_solve_lower(self.l, rhs, mesh, ax, bs)
            del rhs
            if compute_cov == "diag":
                vv = all_reduce_sum(torch.sum(v * v, dim=0), group)
                return mean, torch.clamp_min(var_kernels(k_diag) - vv,
                                             0.0).to(dtype)
            return mean, (var_kernels(k_ss)
                          - all_reduce_sum(v.mT @ v, group)).to(dtype)

        pair = ("nngp", "ntk")
        nngp_c, ntk_c = self._cross_grams(x_test, pair)
        mean = all_reduce_sum(ntk_c @ self.alpha, group)
        if compute_cov is False:
            return mean
        if wide:
            nngp_c, ntk_c = self._mask_pad(var_kernels(
                lambda a, b: gram_cross(spec, a, b, pair)))
        w = distributed_cho_solve(self.l, ntk_c.mT.contiguous(), mesh, ax,
                                  bs)
        del ntk_c
        # K_tt's columns are in natural order: contract against w in
        # natural row order (the one gather this path needs, O(n te))
        w_natural = all_gather_rows(w, group)[self._e2s()]
        kw = _mm_wide(self.k_tt, w_natural)                  # (n/p, te)
        del w_natural
        if compute_cov == "diag":
            sums = all_reduce_sum(torch.stack(
                [torch.sum(w * kw, dim=0), torch.sum(nngp_c.mT * w, dim=0)]),
                group)
            return mean, torch.clamp_min(
                var_kernels(k_diag) + sums[0] - 2.0 * sums[1], 0.0).to(dtype)
        kss = var_kernels(k_ss)
        te = x_test.shape[0]
        # rows of w and kw and columns of nngp_c share the storage order,
        # which cancels inside every n-contraction
        both = all_reduce_sum(torch.cat([w.mT @ kw, nngp_c @ w]), group)
        cross_term = both[te:]
        return mean, (kss + both[:te] - cross_term - cross_term.mT).to(dtype)

    def predict(self, x_test, compute_cov=True):
        """Posterior (mean, cov) in raw units: `GPPosterior.predict`
        semantics from the row-sharded state. compute_cov: True (te, te),
        'diag' (te,) or False."""
        if compute_cov not in (True, False, "diag"):
            raise ValueError(f"compute_cov must be True, False or 'diag', "
                             f"got {compute_cov!r}")
        out = self._predict_scaled(x_test, compute_cov)
        if compute_cov is False or self.input_scale == 1.0:
            return out
        mean, v = out
        return mean, v * (self.input_scale * self.input_scale)

    def predict_mean_std(self, x_test):
        """(mean (te, 1), std (te,)) with the cross Gram sharded over train
        rows and the solves on the sharded factor."""
        mean, var = self._predict_scaled(x_test, "diag")
        return mean, torch.sqrt(var) * self.input_scale

    def predict_mean_std_chunked(self, x_test, chunk: int = 8192):
        """(mean, std) as 1-D numpy arrays, `chunk` test rows per predict
        (the sharded cross Gram stays n * chunk / p per rank)."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        means, stds = [], []
        for s in range(0, x_test.shape[0], chunk):
            mean, std = self.predict_mean_std(x_test[s:s + chunk])
            means.append(mean.reshape(-1).cpu().numpy())
            stds.append(std.reshape(-1).cpu().numpy())
        return np.concatenate(means), np.concatenate(stds)

    # ------------------------------------------------------------ extend
    def extend(self, x_new, y_new) -> "DistributedPosterior":
        """Append labeled rows (raw units) without the O(n^3 / p) refit:
        `_distributed_extend_impl` of the JAX module. Real rows are
        elimination indices [0, n_real); new rows eliminate last, first
        into old pad positions, then into whole new p * block_size quanta.
        One distributed forward solve gives L21 (O(n^2 m / p)), the Schur
        complement's factor is replicated ((m_ext, m_ext)), and the cyclic
        re-layout writes the trailing factor rows. The fit's ridge is kept.
        This posterior is not modified."""
        x_new = self._as_input(x_new)
        if x_new.shape[0] < 1:
            raise ValueError("extend needs at least one row")
        if self.input_scale != 1.0:
            x_new = x_new * (1.0 / self.input_scale)
        y_new = _to_mesh(y_new, self.device, self.dtype)
        if y_new.dim() == 1:
            y_new = y_new[:, None]
        if y_new.shape != (x_new.shape[0], self.y_storage.shape[1]):
            raise ValueError(f"y_new has shape {tuple(y_new.shape)} for "
                             f"{x_new.shape[0]} rows")
        p, d = self._coords()
        b, q = self.block_size, p * self.block_size
        n1, n_old, m_real = self.num_train, self.num_padded, x_new.shape[0]
        n_new = max(n_old, q * -(-(n1 + m_real) // q))
        m_ext = n_new - n1            # trailing region: new rows + fresh pads
        group, mesh, ax = self._group, self.mesh, self.axis_name
        if m_ext > m_real:
            x_ext = torch.cat([x_new, x_new[-1:].expand(m_ext - m_real, -1)])
            y_ext = torch.cat([y_new, y_new.new_zeros((m_ext - m_real,
                                                       y_new.shape[1]))])
        else:
            x_ext, y_ext = x_new, y_new
        x_ext = x_ext.contiguous()
        live_ext = torch.arange(m_ext, device=self.device) < m_real
        ntk = self.get == "ntk"

        # cross kernels of my OLD storage rows vs the trailing region,
        # masked: old pad rows and new pad columns contribute zero
        cross = gram_cross(self.spec, self.x_storage, x_ext,
                           _gets(ntk))
        cross = cross if ntk else (cross,)
        keep_old = self._live_rows()[:, None] & live_ext[None, :]
        cross = [torch.where(keep_old, c, 0.0) for c in cross]
        nngp_c, solve_c = cross[0], cross[-1]

        # L21^T by one distributed forward solve on the old factor (old
        # pad rows of the rhs are zero and the factor is identity there)
        l21t = distributed_tri_solve_lower(self.l, solve_c, mesh, ax, b)

        # Schur complement and its Cholesky, replicated. K22 is a cross
        # Gram of the new rows (generic diagonal), as in the JAX module.
        k22s = gram_cross(self.spec, x_ext, x_ext, _gets(ntk))
        k22s = k22s if ntk else (k22s,)
        live22 = live_ext[:, None] & live_ext[None, :]
        k22 = (torch.where(live22, k22s[-1], 0.0)
               + torch.diag(torch.where(live_ext, self.reg.to(self.dtype),
                                        torch.ones((), dtype=self.dtype,
                                                   device=self.device))))
        schur = k22 - all_reduce_sum(l21t.mT @ l21t, group)
        l22, info = torch.linalg.cholesky_ex(schur)
        if int(info) != 0:
            raise torch.linalg.LinAlgError(
                "extend: the Schur complement is not positive definite")

        # trailing factor rows in natural column order: [L21[:, :n1] | L22]
        e2s = self._e2s()
        l21_nat = all_gather_rows(l21t, group)[e2s][:n1]        # (n1, m_ext)
        ext_rows = torch.cat([l21_nat.mT, l22], dim=1)          # (m_ext, n_new)
        if ntk:
            nngp_nat = all_gather_rows(nngp_c, group)[e2s][:n1]
            ktt_ext = torch.cat([nngp_nat.mT,
                                 torch.where(live22, k22s[0], 0.0)], dim=1)

        # cyclic re-layout: old slots keep their elimination ids, new slots
        # append; rows with e >= n1 (old pads, new slots) take trailing rows
        m_old, m_new = self.l.shape[0], n_new // p
        e_row = _elim_rows(d, m_new, b, p, self.device)
        fresh = torch.nonzero(e_row >= n1).reshape(-1)
        src = e_row[fresh] - n1

        def relayout(old, width, cols_from, ext):
            out = old.new_zeros((m_new, width))
            out[:m_old, :cols_from] = old
            out[fresh] = ext[src]
            return out

        l_new = relayout(self.l, n_new, n_old, ext_rows)
        x_sto = relayout(self.x_storage, x_ext.shape[1], x_ext.shape[1],
                         x_ext)
        y_sto = relayout(self.y_storage, y_ext.shape[1], y_ext.shape[1],
                         y_ext)
        k_new = None
        if ntk:
            k_old = self.k_tt.new_zeros((m_old, n_new))
            k_old[:, :n_old] = self.k_tt
            k_old[:, n1:] = nngp_c               # the new columns, masked
            k_new = relayout(k_old, n_new, n_new, ktt_ext)
        alpha = distributed_cho_solve(l_new, y_sto, mesh, ax, b)
        return dataclasses.replace(
            self, x_storage=x_sto, y_storage=y_sto, l=l_new, alpha=alpha,
            k_tt=k_new, g2e=cyclic_storage_order(n_new, b, p),
            n_real=n1 + m_real)


def distributed_fit(spec: KernelSpec, x, y, mesh, diag_reg: float = 1e-3,
                    get: str = "nngp", axis_name: str = "data",
                    block_size: Optional[int] = None,
                    input_scale: Optional[float] = None
                    ) -> DistributedPosterior:
    """Fit with the Gram row-sharded end to end: block-cyclic storage,
    ridge in the Gram's epilogue, distributed Cholesky (in the Gram's own
    memory) and solves. Collective: every rank passes the same (n, d) x and
    (n,) or (n, 1) y (numpy or tensors); each keeps its storage rows.

    block_size: panel width of the cyclic layout (None -> ceil(n/p), plain
    contiguous blocks). Any n is accepted: it is padded to the p *
    block_size quantum with inert rows whose posterior contribution is
    exactly zero. input_scale: None probes the data for the fp32 prescale,
    as `fit_gp` does.

    Per-rank live memory: one (n/p, n) shard for the solve Gram, which the
    factor overwrites, plus the NNGP Gram's shard for get='ntk'."""
    if get not in ("nngp", "ntk"):
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    _, p, d = topology(mesh, axis_name)
    dev = mesh_device(mesh)
    if input_scale is None:
        input_scale = _auto_input_scale(x, spec.layers)
    x = _to_mesh(x, dev)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    y = _to_mesh(y, dev, x.dtype)
    if y.dim() == 1:
        y = y[:, None]
    if input_scale != 1.0:
        x = x * (1.0 / input_scale)
    n_real = x.shape[0]
    if block_size is None:
        b = -(-n_real // p)                     # ceil: one panel per rank
        n = b * p
    else:
        b = int(block_size)
        n = p * b * -(-n_real // (p * b))
    reg = _ridge(x, spec.layers, get, diag_reg)
    if n > n_real:
        # inert padding: every kernel entry of these rows is masked; the
        # last row repeated keeps the padded Gram tame before the mask
        x = torch.cat([x, x[-1:].expand(n - n_real, -1)])
        y = torch.cat([y, y.new_zeros((n - n_real, y.shape[1]))])
    g2e = cyclic_storage_order(n, b, p)
    m = n // p
    mine = torch.as_tensor(g2e[d * m:(d + 1) * m], device=dev)
    x_sto = x[mine].contiguous()
    y_sto = y[mine].contiguous()
    want_pair = get == "ntk"
    grams = _gram_storage(spec, x_sto, x.contiguous(), reg, p, d, b,
                          want_pair, n_real)
    k_tt, solve_k = grams if want_pair else (None, grams)
    l = distributed_cholesky(solve_k, mesh, axis_name, block_size=b,
                             overwrite=True)
    alpha = distributed_cho_solve(l, y_sto, mesh, axis_name, block_size=b)
    return DistributedPosterior(
        x_storage=x_sto, y_storage=y_sto, l=l, alpha=alpha, reg=reg,
        k_tt=k_tt, spec=spec, get=get, mesh=mesh, axis_name=axis_name,
        block_size=b, g2e=g2e, n_real=n_real,
        input_scale=float(input_scale))

