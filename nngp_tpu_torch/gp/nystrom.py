"""Nystrom (DTC) approximate GP posterior: the streaming tier (PyTorch
counterpart of `nngp_tpu/gp/nystrom.py`).

    K  ~=  Q = K_nm K_mm^+ K_mn          (Nystrom, m inducing rows)

with the inducing set a seeded uniform subset of the training rows, or
one chosen by randomly pivoted Cholesky (`select_inducing_rpchol`). The fit
streams row panels, so device state is O(m^2 + panel * m) at any n:

  1. K_mm comes from `gram_cross(x_m, x_m)` (the same function JAX
     evaluates, `spec.kernel_fn(x_m, x_m)`, so its diagonal carries the
     generic dual's value at rho = 1 in both packages). The whitening
     basis W (W^T K_mm W ~= I) is a jittered Cholesky inverse
     chol(K_mm + j I)^-T, j = rank_rtol * lam_max escalated 10x until the
     factor succeeds ('chol'), or the eigenvalue-truncated eigenbasis
     ('eigh'). It runs in fp64 (`torch.linalg.cholesky_ex`, then
     `solve_triangular`) on the CPU or, with finalize='device', on the
     posterior's device: one implementation, two devices.
  2. Each panel's cross Gram K_pm comes from `gram_cross` (the CUDA kernel
     on a card); it is whitened before squaring, psi_p = W^T K_mp, and

         C += psi_p psi_p^T      b += psi_p y_p
         M1 += W_K^T K_mp psi_p^T                   (ntk only)

     with `torch.matmul` (TF32 off) under precision='highest' or with
     the 3xTF32 GEMM under 'high' (`ops/matmul.py::mm`). The relative
     ridge's trace is the exact diagonal recursion of the panel's rows.
  3. The k x k solve stage runs once, in fp64, on the host or the device:
     ic ic^T = (C + rI)^-1 by Cholesky, falling back to the eigenvalue-
     clamped inverse root when moment noise left C + rI indefinite (noise
     directions revert to the prior 1/r).

Predict: psi* = W^T k_m*, mean = psi*^T beta, var = k** - |psi*|^2 +
r |ic^T psi*|^2 (DTC; the prior diagonal k** stays exact). get='ntk'
Nystrom-approximates both kernels of the mixed covariance through the
streamed moment M1 = W_K^T K_mn T_nm W_T. Moments are row sums, so
`extend` and `forget` add or subtract panels and rerun the solve stage:
exact for this model class.

What differs from the JAX module:
  - moments='df64' runs in native fp64: on an fp32 posterior the K_mm and
    panel kernel entries (the fp64 `gram_cross`), the bases, the
    projections and the accumulators are `torch.float64`, and the
    predict-side projections are rounded to fp32 only after the
    projection, as JAX's `df_round` does. The posterior holds those
    tensors in fp64 where JAX holds (hi, lo) fp32 pairs; `convert.py`
    maps between the two layouts.
  - the last panel runs ragged: no zero-padded tail and no row mask;
  - the device basis escalates its jitter 10x on a failed factor, as the
    host basis does (JAX's emulated-fp64 device basis floors pivots);
  - finalize='auto' resolves to 'device' for a posterior on a CUDA device
    (fp32 or fp64: the device path is native fp64), 'host' on the CPU;
  - with mesh= (`_sharded_panel_fn` in JAX) every rank streams its share
    of each panel (the panel length rounded up to a multiple of the mesh
    size; the rows past n are dropped, where JAX masks its zero-padded
    tail) and one all-reduce a panel sums the (k, k)-sized deltas; every
    rank holds the whole, replicated posterior;
  - with mesh= and inducing='rpchol', rank 0 selects and broadcasts the
    indices;
  - precision='high' runs the products that JAX runs under
    `jax.default_matmul_precision('high')` (the panel moments, the
    predict's projections, the RPCholesky residual and update) in 3xTF32,
    the card's counterpart of the TPU's bf16_3x, through the hand-written
    kernel `csrc/gemm_3xtf32.cu` (its plain twin on the CPU); fp64 products
    stay fp64. The cross Gram stays full fp32 under 'high', where JAX's
    would run bf16_3x: its dot is a small share of the kernel, and a
    reduced-precision dot of raw features is the error
    `nngp_tpu/ops/gram_pallas.py:73-75` warns of. The matrices those
    products read (the K_pm panel, psi, the bases, ic, M1, RPCholesky's F)
    then have rows 16-byte multiples apart whatever m and the rank are
    (`ops/matmul.py::padded_empty`, `padded_copy`), so the GEMM's TMA
    reads them as they lie; their values and shapes do not change.
"""

import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np
import torch

from nngp_tpu_torch.gp.posterior import _as_tensor, _auto_input_scale
from nngp_tpu_torch.models.kernel_spec import (KernelSpec,
                                               apply_diag_recursion,
                                               diag_eval)
from nngp_tpu_torch.ops.gram import input_diag
from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym
from nngp_tpu_torch.ops.matmul import (PRECISIONS, kernel_route, mm,
                                       padded_copy, padded_empty)
from nngp_tpu_torch.parallel.mesh import all_reduce_sum_many
from nngp_tpu_torch.utils.device import resolve_device
from nngp_tpu_torch.utils.profiling import current, span

_DEFAULT_PANEL = 16384


def _default_rank_rtol(dtype, moments: str = "fp32") -> float:
    """The K_mm rank cut (JAX's defaults, so the anchors are the same
    function): fp64 1e-14; fp32 1e-8, the floor set by fp32 K_mm entry
    noise (~6e-8 of lam_max); fp32 with moments='df64' 1e-12, since its
    entries carry fp64 precision."""
    if dtype == torch.float64:
        return 1e-14
    return 1e-12 if moments == "df64" else 1e-8


def select_inducing(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Seeded uniform inducing subset (sorted for locality)."""
    if m >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=m, replace=False))


def _check_precision(precision: str):
    """'highest' (full IEEE products, TF32 off) or 'high' (3xTF32 products
    on fp32, `ops/matmul.py`); anything else raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'highest' or 'high', got "
                         f"{precision!r}")


def _product_out(rows, cols, precision, dtype, device):
    """The (rows, cols) output of a product, or of a Gram panel, that a
    product at `precision` reads next: under 'high' on fp32 one whose rows
    TMA can address whatever `cols` is (`padded_empty`: a row stride of
    cols rounded up to 4 floats), so that the 3xTF32 GEMM reads it as it
    lies; else None (the call allocates its own)."""
    if not kernel_route(precision, dtype):
        return None
    return padded_empty(rows, cols, dtype, device)


def _laid_out(t, precision):
    """t, or under 'high' on fp32 an equal tensor whose rows TMA can
    address (`padded_copy`): for the matrices the products read again and
    again (the bases, ic, M1, RPCholesky's F)."""
    if t is None or not kernel_route(precision, t.dtype):
        return t
    return padded_copy(t)


def _rpchol_panel(spec, get, x_c, x_s, sel, f, precision="highest"):
    """One proposal panel's residual columns: g = K(x_c, x_S) - F F_S^T,
    and its proposal rows g[sel]. Unfilled F columns are zero, so the
    full-width product is exact. The product is subtracted from the cross
    Gram in place (alpha = -1, beta = 1)."""
    if get == "ntk":
        _, k_cs = gram_cross(spec, x_c, x_s, ("nngp", "ntk"))
    else:
        k_cs = gram_cross(spec, x_c, x_s, "nngp")
    g = mm(f, f[sel].mT, precision, out=k_cs, alpha=-1.0, beta=1.0)
    return g, g[sel]


def _rpchol_update(g, perm, inv_lt, f, d, j, precision="highest"):
    """Accept a round's pivots: F[:, j:j+B] = g[:, perm] @ invL^T (columns
    past the accepted rank are zero in inv_lt: they land as zeros and
    later rounds overwrite them), residual diagonal -= row norms."""
    f_new = mm(g[:, perm], inv_lt, precision)
    f[:, j:j + f_new.shape[1]] = f_new
    return torch.clamp_min(d - torch.sum(f_new * f_new, dim=1), 0.0)


def select_inducing_rpchol(spec: KernelSpec, x, m: int, get: str = "nngp",
                           seed: int = 0, block: int = 64,
                           max_candidates: int = 65536,
                           precision: str = "highest",
                           device=None) -> np.ndarray:
    """Block randomly pivoted Cholesky (RPCholesky) inducing selection: the
    counterpart of `nngp_tpu/gp/nystrom.py::select_inducing_rpchol`, with
    the same host algorithm and random draws, so the same rows give the
    same indices.

    Pivots are drawn with probability proportional to the RESIDUAL kernel
    diagonal d_i = K_ii - |F_i|^2 after projecting out the chosen columns:
    near trace-optimal column Nystrom (Chen, Epperly, Tropp & Webber,
    "Randomly pivoted Cholesky", 2022). It beats uniform selection on the
    trace error, but uniform wins on predictive q-error where the held-out
    queries follow the train density (forest and synth6,
    experiments/nystrom_rpchol_ab.log): opt in when the serving
    distribution will not follow it.

    Each round: one `gram_cross` of the candidates against the B proposals
    and the residual g = K(x_c, x_S) - F F_S^T on the device; the B x B
    proposal block factored on the host in fp64 (LAPACK dpstrf, pivoted,
    and dtrtri) to accept the linearly independent proposals; one update
    on the device appends the accepted columns to F and downdates d. F
    (n_c, m + B) and d stay on the device; the host reads d and the B x B
    block once a round.

    x: (n, d) rows (numpy or a tensor) as the fit sees them (prescaled);
    device: where the work runs (required for numpy input, a tensor's own
    device by default). With n > max_candidates the pivots come from a
    seeded uniform subsample of the candidates. May return fewer than m
    indices when the kernel is numerically rank-deficient on the
    candidates. precision: 'highest' or 'high' (the residual and update
    products in 3xTF32 on fp32 rows, as JAX runs them at Precision.HIGH)."""
    from scipy.linalg import lapack

    _check_precision(precision)
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise ValueError("select_inducing_rpchol needs device= for "
                             "numpy input")
        device = x.device
    device = resolve_device(device)
    n = x.shape[0]
    if m >= n:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    if n > max_candidates:
        cand = np.sort(rng.choice(n, size=max_candidates, replace=False))
    else:
        cand = np.arange(n)
    nc = cand.shape[0]
    x = _as_tensor(x, device)
    x_c = x[torch.as_tensor(cand, device=device)].contiguous()
    d = spec.diag_fn(x_c, get)
    trace0 = float(torch.sum(d))
    f = _laid_out(torch.zeros((nc, m + block), dtype=x_c.dtype,
                              device=device), precision)
    chosen: list = []
    taken = np.zeros(nc, dtype=bool)
    j = 0
    max_rounds = 4 * (-(-m // block)) + 4
    for _ in range(max_rounds):
        if j >= m:
            break
        d_host = d.cpu().numpy().astype(np.float64)
        d_host[taken] = 0.0
        tot = float(d_host.sum())
        if tot <= 1e-12 * max(trace0, 1.0):
            break                       # numerically exhausted
        sel = rng.choice(nc, size=block, p=d_host / tot)
        sel_t = torch.as_tensor(sel, device=device)
        g, h_small = _rpchol_panel(spec, get, x_c, x_c[sel_t], sel_t, f,
                                   precision)
        h64 = h_small.cpu().numpy().astype(np.float64)
        h64 = 0.5 * (h64 + h64.T)
        # pivoted Cholesky of the proposal block: P^T H P = L L^T, rank r
        c_fact, piv, r, info = lapack.dpstrf(h64, lower=1)
        if info < 0 or r == 0:
            continue                    # all proposals dependent; resample
        r = min(int(r), m - j)
        perm = sel[piv[:r] - 1]         # dpstrf pivots are 1-based
        li, tinfo = lapack.dtrtri(np.tril(c_fact[:r, :r]), lower=1)
        if tinfo != 0:
            continue
        inv_lt = np.zeros((block, block), np.float64)
        inv_lt[:r, :r] = li.T           # cols >= r stay zero (rejected)
        d = _rpchol_update(
            g, torch.as_tensor(piv[:block] - 1, device=device),
            torch.as_tensor(inv_lt, dtype=x_c.dtype, device=device), f, d, j,
            precision)
        # taken[] guards the sampler, so the accepted pivots are fresh
        chosen.extend(int(p) for p in perm)
        taken[perm] = True
        j += r
    if not chosen:
        raise ValueError(
            "RPCholesky selected no pivots — degenerate kernel diagonal "
            "(all-zero rows?)")
    return np.sort(cand[np.asarray(chosen[:m])])


# ------------------------------------------------------- whitening bases
# Both bases and the solve stage are one fp64 torch implementation; where it
# runs is a device: the CPU for 'host' (LAPACK), the posterior's device for
# 'device' (cuSOLVER on a card).
_HOST = torch.device("cpu")


def _whiten_basis(kmm64: torch.Tensor, rank_rtol: float) -> torch.Tensor:
    """Truncated inverse-sqrt eigenbasis W (m, k): W^T K_mm W = I_k."""
    lam, v = torch.linalg.eigh(0.5 * (kmm64 + kmm64.mT))
    keep = lam > rank_rtol * max(float(lam[-1]), 0.0)
    if not bool(torch.any(keep)):
        raise ValueError(
            "K_mm has no eigenvalue above rank_rtol * lam_max — degenerate "
            "inducing set (all-identical rows?)")
    return v[:, keep] / torch.sqrt(lam[keep])[None, :]


def _lam_max_estimate(sym64: torch.Tensor, iters: int = 16) -> float:
    """Power-iteration lambda_max of a symmetric PSD matrix, floored at its
    largest diagonal entry. One host sync, at the end."""
    m = sym64.shape[0]
    v = sym64.new_full((m,), 1.0 / math.sqrt(m))
    lam = sym64.new_zeros(())
    for _ in range(iters):
        w = sym64 @ v
        lam = v @ w
        v = w / torch.clamp_min(torch.linalg.norm(w), 1e-300)
    return max(float(lam), float(torch.max(torch.diagonal(sym64))))


def _whiten_basis_chol(kmm64: torch.Tensor,
                       rank_rtol: float) -> torch.Tensor:
    """Jittered-Cholesky whitening basis W = chol(K_mm + j I)^-T (m, m) on
    K_mm's device, j = rank_rtol * lam_max escalated 10x until the factor
    succeeds (fp32 kernel noise can leave the fp64 copy slightly
    indefinite). One host sync per attempt (the factor's info), each
    counted into the open span's `attempts`."""
    sym = 0.5 * (kmm64 + kmm64.mT)
    m = sym.shape[0]
    lam_max = _lam_max_estimate(sym)
    if lam_max <= 0.0:
        raise ValueError(
            "K_mm has non-positive spectrum — degenerate inducing set "
            "(all-identical rows?)")
    jitter = rank_rtol * lam_max
    eye = torch.eye(m, dtype=sym.dtype, device=sym.device)
    for _ in range(8):
        current().add("attempts")
        ell, info = torch.linalg.cholesky_ex(sym + jitter * eye)
        if int(info) != 0:
            jitter *= 10.0
            continue
        return torch.linalg.solve_triangular(ell, eye,
                                             upper=False).mT.contiguous()
    raise torch.linalg.LinAlgError(
        "K_mm not factorizable even at jitter "
        f"{jitter:.3e} (lam_max ~ {lam_max:.3e})")


_BASES_CACHE = {}
_BASES_CACHE_MAX = 4


def _inducing_bases(spec, get, rank_rtol, x_m, whiten="chol", device=False,
                    entries="fp32"):
    """(w_solve, w_kmm) whitening bases of K_mm; w_kmm (the NNGP basis) is
    None unless get='ntk'. entries='df64' evaluates K_mm with the fp64
    kernel on the fp32 rows and returns fp64 bases; otherwise the bases
    come back in x_m's dtype. device=True (whiten='chol' only) factors on
    x_m's device instead of the host.

    Cached on the value of the inducing set (sha1 of its bytes) with the
    spec, get, rtol, whiten, device and entries: repeated fits with the
    same inducing rows (active-learning refits, timing loops) reuse it.
    At most 4 entries, each two concrete (m, k) tensors. Span
    `nystrom.bases` (attrs cached, and the whitening's factor attempts)."""
    if device and whiten != "chol":
        raise ValueError("device bases require whiten='chol' (the eigh "
                         "basis is a host semantics anchor)")
    df64 = entries == "df64"
    out_dtype = torch.float64 if df64 else x_m.dtype
    with span("nystrom.bases", cached=False) as sp:
        key = (spec, get, float(rank_rtol), whiten, bool(device), entries,
               str(x_m.dtype), str(x_m.device), tuple(x_m.shape),
               hashlib.sha1(x_m.cpu().numpy().tobytes()).hexdigest())
        hit = _BASES_CACHE.get(key)
        if hit is not None:
            sp.set(cached=True)
            return hit
        xe = x_m.to(torch.float64) if df64 else x_m
        if get == "ntk":
            kmm_nngp, kmm_solve = gram_cross(spec, xe, xe, ("nngp", "ntk"))
        else:
            kmm_nngp, kmm_solve = None, gram_cross(spec, xe, xe, "nngp")
        basis_fn = _whiten_basis_chol if whiten == "chol" else _whiten_basis
        where = x_m.device if device else _HOST
        out = tuple(None if k is None else basis_fn(
            k.to(device=where, dtype=torch.float64), rank_rtol).to(
                device=x_m.device, dtype=out_dtype).contiguous()
            for k in (kmm_solve, kmm_nngp))
        if len(_BASES_CACHE) >= _BASES_CACHE_MAX:
            _BASES_CACHE.pop(next(iter(_BASES_CACHE)))
        _BASES_CACHE[key] = out
        return out


# ---------------------------------------------------------- solve stage
def _resolve_finalize(mode: str, device) -> str:
    """'auto' -> 'device' for a posterior on a CUDA device, 'host' on the
    CPU (whose fp64 LAPACK is native there)."""
    if mode not in ("host", "device", "auto"):
        raise ValueError(
            f"finalize must be 'host', 'device' or 'auto', got {mode!r}")
    if mode == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    return mode


def _finalize(c_raw, b_w, reg, dtype, mode: str):
    """The k x k solve stage in fp64, on the CPU (mode 'host') or on the
    moments' device ('device'): (ic, beta) with ic ic^T = (C + rI)^-1 and
    beta = that @ b, returned on the moments' device. Cholesky, then L^-1
    by `solve_triangular`; if moment noise left C + rI indefinite, the
    eigenvalue-clamped inverse root (noise directions revert to the prior
    1/r). One host sync, the factor's info. Span `nystrom.finalize`."""
    with span("nystrom.finalize", mode=mode):
        where = c_raw.device if mode == "device" else _HOST
        c64 = c_raw.detach().to(device=where, dtype=torch.float64)
        c64 = 0.5 * (c64 + c64.mT)
        r = reg.detach().to(device=where, dtype=torch.float64)
        eye = torch.eye(c64.shape[0], dtype=torch.float64, device=where)
        ell, info = torch.linalg.cholesky_ex(c64 + r * eye)
        if int(info) == 0:
            ic64 = torch.linalg.solve_triangular(ell, eye, upper=False).mT
        else:
            lam, v = torch.linalg.eigh(c64)
            ic64 = v * torch.rsqrt(torch.clamp_min(lam, 0.0) + r)[None, :]
        beta64 = ic64 @ (ic64.mT @ b_w.detach().to(device=where,
                                                    dtype=torch.float64))
        return (ic64.to(device=c_raw.device, dtype=dtype).contiguous(),
                beta64.to(device=c_raw.device, dtype=dtype))


# ------------------------------------------------------------ streaming
def _panel_deltas(spec, get, x_me, w_solve, w_kmm, x_p, y_p,
                  precision="highest"):
    """The whitened moments of one panel's rows: (dC, db, dM1 or None,
    d diag_sum, d yty), the products at `precision`."""
    def out(cols):        # the next product's operand, laid out for it
        return _product_out(x_p.shape[0], cols, precision, x_me.dtype,
                            x_me.device)

    m = x_me.shape[0]
    if get == "ntk":
        pair = out(m)
        nngp_pm, solve_pm = gram_cross(spec, x_p, x_me, ("nngp", "ntk"),
                                       out=None if pair is None
                                       else (pair, out(m)))
    else:
        solve_pm = gram_cross(spec, x_p, x_me, "nngp", out=out(m))
    psi = mm(solve_pm, w_solve, precision,
             out=out(w_solve.shape[1])).mT     # (k, p)
    dm1 = (mm(mm(nngp_pm, w_kmm, precision, out=out(w_kmm.shape[1])).mT,
              psi.mT, precision) if get == "ntk" else None)
    # the relative ridge's trace: the exact solve-kernel diagonal
    dn, dt = apply_diag_recursion(input_diag(x_p), spec.layers)
    return (mm(psi, psi.mT, precision), mm(psi, y_p, precision), dm1,
            torch.sum(dt if get == "ntk" else dn), torch.sum(y_p * y_p))


def _stream_moments(spec, get, x_m, w_solve, w_kmm, x, y, panel_size,
                    c_raw=None, b_w=None, m1_w=None, diag_sum=None,
                    yty=None, mesh=None, mesh_axis="data",
                    precision="highest"):
    """Panel loop over the (n, d) rows x and (n, 1) labels y (tensors on
    x_m's device, prescaled): the whitened moments of every panel, their
    products at `precision`, added to the given accumulators, or to zeros.
    The moments run in the bases' dtype (fp64 for moments='df64'); the
    last panel is ragged. Returns (c_raw, b_w, m1_w or None, diag_sum,
    yty).

    With `mesh` (collective: every rank passes the same rows) the panel
    length rounds up to a multiple of the mesh size q, rank r streams rows
    [r p/q, (r + 1) p/q) of each panel (the rows past n add nothing), and
    the deltas are summed over ranks before they are added. One span
    `nystrom.panel` a panel (attr rows, this rank's)."""
    mdt = w_solve.dtype
    dev = x_m.device
    k = w_solve.shape[1]
    x_me = x_m.to(mdt)
    if c_raw is None:
        c_raw = torch.zeros((k, k), dtype=mdt, device=dev)
        b_w = torch.zeros((k, 1), dtype=mdt, device=dev)
        m1_w = (torch.zeros((w_kmm.shape[1], k), dtype=mdt, device=dev)
                if get == "ntk" else None)
        diag_sum = torch.zeros((), dtype=mdt, device=dev)
    if yty is None:
        yty = torch.zeros((), dtype=mdt, device=dev)
    n = x.shape[0]
    p = min(panel_size, max(n, 1))
    q, rank = 1, 0
    if mesh is not None:
        q, rank = int(mesh.size()), int(mesh.get_local_rank(mesh_axis))
        p = -(-p // q) * q
    share = p // q
    for s in range(0, n, p):
        lo, hi = s + rank * share, min(s + (rank + 1) * share, n)
        with span("nystrom.panel", rows=max(hi - lo, 0)):
            if lo < hi:
                deltas = _panel_deltas(spec, get, x_me, w_solve, w_kmm,
                                       x[lo:hi].to(mdt).contiguous(),
                                       y[lo:hi].to(mdt), precision)
            else:             # this rank's share lies past the last row
                deltas = (torch.zeros_like(c_raw), torch.zeros_like(b_w),
                          None if m1_w is None else torch.zeros_like(m1_w),
                          torch.zeros_like(diag_sum), torch.zeros_like(yty))
            if mesh is not None:
                deltas = all_reduce_sum_many(deltas,
                                             mesh.get_group(mesh_axis))
            dc, db, dm1, dd, dy2 = deltas
            c_raw = c_raw + dc
            b_w = b_w + db
            if get == "ntk":
                m1_w = m1_w + dm1
            diag_sum = diag_sum + dd
            yty = yty + dy2
    return c_raw, b_w, m1_w, diag_sum, yty


# ------------------------------------------------------------ posterior
@dataclasses.dataclass
class NystromPosterior:
    """Nystrom/DTC posterior, all tensors on one device. Same predict
    surface as `GPPosterior`. The moment fields (w_solve, w_kmm, c_raw,
    b_w, m1_w, diag_sum, yty) are fp64 for moments='df64' and in the
    posterior's dtype otherwise; x_m, ic, beta_w and reg always in the
    posterior's dtype."""

    x_m: torch.Tensor                 # (m, d) inducing rows, prescaled
    w_solve: torch.Tensor             # (m, k) whitening basis, solve kernel
    ic: torch.Tensor                  # (k, k): ic ic^T = (clamp(C) + r I)^-1
    beta_w: torch.Tensor              # (k, 1) whitened weights
    reg: torch.Tensor                 # scalar ridge actually used
    c_raw: torch.Tensor               # (k, k) sum psi psi^T
    b_w: torch.Tensor                 # (k, 1) sum psi y
    diag_sum: torch.Tensor            # sum of the true solve-kernel diagonal
    m1_w: Optional[torch.Tensor]      # (k2, k) W_K^T K_mn T_nm W_T, ntk only
    w_kmm: Optional[torch.Tensor]     # (m, k2) NNGP whitening, ntk only
    spec: KernelSpec
    get: str = "nngp"
    diag_reg: float = 1e-3
    num_train: int = 0
    input_scale: float = 1.0
    # the products' precision: 'highest' or 'high' (3xTF32 on fp32)
    precision: str = "highest"
    rank_rtol: float = 1e-6
    panel_size: int = _DEFAULT_PANEL
    # where the k x k solve stage runs; extend/forget/grow reuse it
    finalize: str = "host"
    # streamed sum of y^2 (the DTC evidence's quadratic term); None on
    # posteriors restored from checkpoints that predate it
    yty: Optional[torch.Tensor] = None
    moments: str = "fp32"
    # runtime only, not checkpoint state: extend / forget / grow stream
    # their rows over this mesh (collective: every rank calls them)
    mesh: Optional[object] = None
    mesh_axis: str = "data"

    def __post_init__(self):
        # under 'high' the fp32 matrices that the predict's and the
        # moments' products read get rows TMA can address whatever the
        # rank (`padded_copy`; the values and shapes are unchanged), at
        # fit, extend, grow and checkpoint restore alike
        for name in ("w_solve", "w_kmm", "ic", "m1_w"):
            setattr(self, name, _laid_out(getattr(self, name),
                                          self.precision))

    @property
    def device(self) -> torch.device:
        return self.x_m.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x_m.dtype

    @property
    def num_inducing(self) -> int:
        return self.x_m.shape[0]

    @property
    def rank(self) -> int:
        """Whitening-basis dimension after truncation."""
        return self.w_solve.shape[1]

    def _as_input(self, x):
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"input is on {x.device}, the posterior on "
                                 f"{self.device}")
            return x.to(self.dtype).contiguous()
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device).contiguous()

    def _labels(self, y, rows: int):
        y = _as_tensor(y, self.device, self.dtype)
        if y.dim() == 1:
            y = y[:, None]
        if y.shape != (rows, 1):
            raise ValueError(f"labels have shape {tuple(y.shape)} for "
                             f"{rows} rows")
        return y

    # ------------------------------------------------------------ predict
    def _projections(self, x_test, need_kmm):
        """(psi_solve (k, mt), psi_kmm (k2, mt) or None) of prescaled test
        rows. moments='df64': kernel entries and projections in fp64,
        rounded to the posterior's dtype after the projection."""
        df64 = self.moments == "df64"
        xe = x_test.to(torch.float64) if df64 else x_test
        xm = self.x_m.to(torch.float64) if df64 else self.x_m
        p = self.precision

        def out(cols):        # the next product's operand, laid out for it
            return _product_out(xe.shape[0], cols, p, xe.dtype, xe.device)

        k, m = self.w_solve.shape[1], xm.shape[0]
        psi_k = None
        if self.get == "nngp":
            cross = gram_cross(self.spec, xe, xm, "nngp", out=out(m))
            psi = mm(cross, self.w_solve, p, out=out(k)).mT
        elif need_kmm:
            pair = out(m)
            nngp_c, ntk_c = gram_cross(self.spec, xe, xm, ("nngp", "ntk"),
                                       out=None if pair is None
                                       else (pair, out(m)))
            psi = mm(ntk_c, self.w_solve, p, out=out(k)).mT
            psi_k = mm(nngp_c, self.w_kmm, p,
                       out=out(self.w_kmm.shape[1])).mT.to(self.dtype)
        else:
            psi = mm(gram_cross(self.spec, xe, xm, "ntk"), self.w_solve,
                     p, out=out(k)).mT
        return psi.to(self.dtype), psi_k

    def _predict_scaled(self, x_test, compute_cov):
        """Predict body on raw-unit x_test: the mean is exact, var/cov come
        back divided by input_scale^2. The products run at
        `self.precision`."""
        resolve_device(self.device)
        x_test = self._as_input(x_test)
        if self.input_scale != 1.0:
            x_test = x_test * (1.0 / self.input_scale)
        layers = self.spec.layers
        p = self.precision

        def out(rows):        # the next product's operand, laid out for it
            return _product_out(rows, x_test.shape[0], p, self.dtype,
                                self.device)

        k = self.ic.shape[0]
        if self.get == "nngp":
            psi, _ = self._projections(x_test, False)
            mean = mm(psi.mT, self.beta_w, p)
            if compute_cov is False:
                return mean
            h = mm(self.ic.mT, psi, p,
                   out=out(k) if compute_cov is True else None)
            if compute_cov == "diag":
                var = (diag_eval(layers, x_test, "nngp")
                       - torch.sum(psi * psi, dim=0)
                       + self.reg * torch.sum(h * h, dim=0))
                return mean, torch.clamp_min(var, 0.0)
            k_ss = gram_sym(self.spec, x_test, "nngp")   # exact diagonal
            return mean, k_ss - mm(psi.mT, psi, p) + self.reg * mm(h.mT, h,
                                                                   p)

        # get == 'ntk': both kernels Nystrom-approximated
        psi_t, psi_k = self._projections(x_test, compute_cov is not False)
        mean = mm(psi_t.mT, self.beta_w, p)
        if compute_cov is False:
            return mean
        # (C + rI)^-1 psi_t, then g (k2, mt)
        ct = mm(self.ic, mm(self.ic.mT, psi_t, p, out=out(k)), p,
                out=out(k))
        g = mm(self.m1_w.to(self.dtype), ct, p,
               out=out(self.m1_w.shape[0]) if compute_cov is True else None)
        if compute_cov == "diag":
            var = (diag_eval(layers, x_test, "nngp")
                   + torch.sum(g * g, dim=0)
                   - 2.0 * torch.sum(psi_k * g, dim=0))
            return mean, torch.clamp_min(var, 0.0)
        k_ss = gram_sym(self.spec, x_test, "nngp")
        return mean, (k_ss + mm(g.mT, g, p) - mm(psi_k.mT, g, p)
                      - mm(g.mT, psi_k, p))

    def predict(self, x_test, compute_cov=True):
        """Posterior (mean, cov) in raw input units: `GPPosterior.predict`
        with K replaced by its Nystrom approximation and the exact prior
        diagonal k** (the DTC predictive). compute_cov: True, 'diag' or
        False."""
        if compute_cov not in (True, False, "diag"):
            raise ValueError(f"compute_cov must be True, False or 'diag', "
                             f"got {compute_cov!r}")
        out = self._predict_scaled(x_test, compute_cov)
        if compute_cov is False or self.input_scale == 1.0:
            return out
        mean, v = out
        return mean, v * (self.input_scale * self.input_scale)

    def predict_mean_std(self, x_test):
        """(mean (m, 1), std (m,)); std compensated after the sqrt so fp32
        stays finite at any input_scale."""
        mean, var = self._predict_scaled(x_test, "diag")
        return mean, torch.sqrt(var) * self.input_scale

    def predict_mean_std_chunked(self, x_test, chunk: int = 8192):
        """(mean, std) as 1-D numpy arrays, `chunk` rows per predict."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        means, stds = [], []
        for s in range(0, x_test.shape[0], chunk):
            mean, std = self.predict_mean_std(x_test[s:s + chunk])
            means.append(mean.reshape(-1).cpu().numpy())
            stds.append(std.reshape(-1).cpu().numpy())
        return np.concatenate(means), np.concatenate(stds)

    # ----------------------------------------------------- extend, forget
    def _stream(self, x, y, **acc):
        resolve_device(self.device)
        x = self._as_input(x)
        y = self._labels(y, x.shape[0])
        if self.input_scale != 1.0:
            x = x * (1.0 / self.input_scale)
        return x.shape[0], _stream_moments(
            self.spec, self.get, self.x_m, self.w_solve, self.w_kmm, x, y,
            self.panel_size, mesh=self.mesh, mesh_axis=self.mesh_axis,
            precision=self.precision, **acc)

    def extend(self, x_new, y_new) -> "NystromPosterior":
        """Add labeled rows (raw units): their moments are accumulated and
        the k x k solve stage reruns, O(s m^2 + m^3). Exact: extend then
        predict equals a refit on the concatenated rows with the same
        inducing set and ridge. The fit's ridge is kept."""
        s, (c_raw, b_w, m1_w, diag_sum, yty) = self._stream(
            x_new, y_new, c_raw=self.c_raw, b_w=self.b_w, m1_w=self.m1_w,
            diag_sum=self.diag_sum, yty=self.yty)
        ic, beta_w = _finalize(c_raw, b_w, self.reg, self.dtype,
                               self.finalize)
        return dataclasses.replace(
            self, ic=ic, beta_w=beta_w, c_raw=c_raw, b_w=b_w, m1_w=m1_w,
            diag_sum=diag_sum, yty=yty if self.yty is not None else None,
            num_train=self.num_train + s)

    def forget(self, x_old, y_old) -> "NystromPosterior":
        """Remove rows added before by subtracting their moments and
        rerunning the solve stage: forget(extend(rows)) is the posterior
        without them. The rows must be those streamed in (same features
        and labels); a mismatch cannot be detected here."""
        rows = len(x_old)
        if rows > self.num_train:
            raise ValueError(f"forget({rows} rows) exceeds num_train "
                             f"({self.num_train})")
        _, (dc, db, dm1, dd, dy2) = self._stream(x_old, y_old)
        c_raw = self.c_raw - dc
        b_w = self.b_w - db
        m1_w = self.m1_w - dm1 if self.get == "ntk" else None
        ic, beta_w = _finalize(c_raw, b_w, self.reg, self.dtype,
                               self.finalize)
        return dataclasses.replace(
            self, ic=ic, beta_w=beta_w, c_raw=c_raw, b_w=b_w, m1_w=m1_w,
            diag_sum=self.diag_sum - dd,
            yty=self.yty - dy2 if self.yty is not None else None,
            num_train=self.num_train - rows)

    def grow_inducing(self, x_new_inducing, x_train, y_train):
        """Refit on (x_train, y_train) with the inducing set enlarged by
        `x_new_inducing` (raw units). The whitening basis changes, so this
        is a full streamed refit, O(n (m + s)^2); the Titsias ELBO cannot
        decrease."""
        old_raw = self.x_m.to(torch.float64) * float(self.input_scale)
        new = _as_tensor(x_new_inducing, self.device, torch.float64)
        rows = torch.cat([old_raw, new])
        return fit_nystrom(
            self.spec, x_train, y_train, diag_reg=self.diag_reg,
            get=self.get, panel_size=self.panel_size,
            rank_rtol=self.rank_rtol, input_scale=self.input_scale,
            precision=self.precision, inducing_rows=rows,
            finalize=self.finalize, moments=self.moments, mesh=self.mesh,
            mesh_axis=self.mesh_axis, device=self.device)

    # ---------------------------------------------------- model evidence
    def log_evidence(self) -> float:
        """Closed-form log evidence of y ~ N(0, Q + rI):
        quad = (y^T y - |ic^T b|^2) / r, logdet = (n - k) log r
        - 2 log|det ic|; with a prescale s, quad / s^2 and n log s^2."""
        if self.yty is None:
            raise ValueError(
                "log_evidence needs the streamed y^T y moment; this "
                "posterior predates evidence tracking — refit")
        n, k = self.num_train, self.rank
        r = float(self.reg)
        ic64 = self.ic.to(torch.float64)
        h = (ic64.mT @ self.b_w.to(torch.float64)).reshape(-1)
        quad = (float(self.yty) - float(h @ h)) / r
        _, logabs = torch.linalg.slogdet(ic64)
        logdet = (n - k) * math.log(r) - 2.0 * float(logabs)
        if self.input_scale != 1.0:
            s2 = float(self.input_scale) ** 2
            quad /= s2
            logdet += n * math.log(s2)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    def capacity_gap(self) -> float:
        """Per-row Nystrom gap tr(K - Q) / (n r): the ELBO's trace penalty
        per training row in ridge units."""
        trace_gap = float(self.diag_sum) - float(
            torch.trace(self.c_raw.to(torch.float64)))
        return max(trace_gap, 0.0) / (max(self.num_train, 1)
                                      * float(self.reg))

    def elbo(self) -> float:
        """Titsias' collapsed lower bound on the exact GP evidence:
        log_evidence() - tr(K - Q) / (2 r), monotone non-decreasing under
        inducing-set inclusion."""
        return self.log_evidence() - 0.5 * self.capacity_gap() * \
            max(self.num_train, 1)


# ------------------------------------------------------------------- fit
def _rpchol_indices(spec, x, m, get, seed, mesh, mesh_axis, precision):
    """`select_inducing_rpchol` on the prescaled rows x, as a tensor of
    indices on x's device. With a mesh (collective) coordinate 0 selects
    and broadcasts the count, then the indices, so every rank holds the
    same inducing rows."""
    if mesh is None:
        return torch.as_tensor(select_inducing_rpchol(
            spec, x, m, get=get, seed=seed, precision=precision),
            device=x.device)
    import torch.distributed as dist

    from nngp_tpu_torch.parallel.mesh import owner_broadcast

    group = mesh.get_group(mesh_axis)
    idx = None
    if dist.get_rank(group) == 0:
        idx = torch.as_tensor(select_inducing_rpchol(
            spec, x, m, get=get, seed=seed, precision=precision),
            device=x.device)
    like = torch.zeros(1, dtype=torch.int64, device=x.device)
    count = owner_broadcast(lambda: like + idx.numel(), 0, (1,), like, group)
    return owner_broadcast(lambda: idx, 0, (int(count),), like, group)


def fit_nystrom(spec: KernelSpec, x_train, y_train, num_inducing: int = 2048,
                diag_reg: float = 1e-3, get: str = "nngp",
                diag_reg_absolute_scale: bool = False, seed: int = 0,
                panel_size: int = _DEFAULT_PANEL,
                rank_rtol: Optional[float] = None,
                input_scale: Optional[float] = None,
                precision: str = "highest", whiten: str = "chol",
                inducing: str = "uniform", inducing_rows=None,
                mesh=None, mesh_axis: str = "data",
                finalize: str = "auto", moments: str = "fp32",
                device=None) -> NystromPosterior:
    """Streaming Nystrom/DTC fit: O(n m^2) flops, O(m^2 + panel * m)
    device memory. The arguments of the JAX function, plus `device` (where
    the posterior lives; required for numpy input, a tensor's own device by
    default). x_train's dtype (fp32 or fp64) is the posterior's.
    input_scale None probes max|x| on the rows once they are on the
    device (one reduction, one scalar read back), not on the caller's
    host array: the same scale, bit for bit.

    whiten: 'chol' (jittered Cholesky basis, rank m) or 'eigh' (the
    eigenvalue-truncated basis, rank <= m). inducing_rows: explicit (m, d)
    inducing rows in raw units, overriding the seeded uniform selection
    (the hook `grow_inducing` uses). inducing: 'uniform' (the seeded
    subset) or 'rpchol' (`select_inducing_rpchol` on the prescaled rows,
    with the fit's spec, get and seed; may give fewer than num_inducing
    rows; with mesh= rank 0 selects and broadcasts the indices).
    finalize: 'host', 'device' or 'auto'.
    precision: 'highest' (full IEEE products) or 'high' (the moment,
    predict and RPCholesky products of an fp32 posterior in 3xTF32,
    `ops/matmul.py`; fp64 products are unchanged), as JAX's precision.
    moments: 'fp32' or 'df64' (fp32 posteriors only: the kernel entries,
    bases, projections and accumulators in fp64, with the rank cut 1e-12;
    its fp64 products ignore precision, as JAX's df64 path does).
    mesh: a `parallel.make_mesh` DeviceMesh: every panel's rows are split
    over its ranks and the moment deltas summed over them (collective:
    every rank passes the same rows and gets the same posterior, which
    keeps the mesh for extend and forget). The device is then the mesh's.
    """
    if get not in ("nngp", "ntk"):
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    if mesh is not None:
        from nngp_tpu_torch.parallel.mesh import (check_mesh_device,
                                                  mesh_device)
        if device is not None:
            check_mesh_device(mesh, device)
        device = mesh_device(mesh)
    _check_precision(precision)
    if inducing not in ("uniform", "rpchol"):
        raise ValueError(
            f"inducing must be 'uniform' or 'rpchol', got {inducing!r}")
    if whiten not in ("chol", "eigh"):
        raise ValueError(f"whiten must be 'chol' or 'eigh', got {whiten!r}")
    if moments not in ("fp32", "df64"):
        raise ValueError(f"moments must be 'fp32' or 'df64', "
                         f"got {moments!r}")
    if device is None:
        if not isinstance(x_train, torch.Tensor):
            raise ValueError("fit_nystrom needs device= for numpy input")
        device = x_train.device
    device = resolve_device(device)
    finalize = _resolve_finalize(finalize, device)
    with span("nystrom.fit", rows=len(x_train), panel=panel_size) as sp:
        with span("nystrom.prepare", rows=len(x_train),
                  probe="device" if input_scale is None else "given"):
            x = _as_tensor(x_train, device)
            if x.dtype not in (torch.float32, torch.float64):
                raise TypeError("x_train must be float32 or float64, got "
                                f"{x.dtype}")
            if moments == "df64" and x.dtype != torch.float32:
                raise ValueError("moments='df64' is the fp64-moment path for "
                                 f"fp32 posteriors; got dtype {x.dtype} "
                                 "(fp64 already carries full precision)")
            y = _as_tensor(y_train, device, x.dtype)
            if y.dim() == 1:
                y = y[:, None]
            n = x.shape[0]
            if input_scale is None:
                input_scale = _auto_input_scale(x, spec.layers)
            if input_scale != 1.0:
                x = x * (1.0 / input_scale)
            if inducing_rows is not None:
                x_m = _as_tensor(inducing_rows, device, x.dtype)
                if input_scale != 1.0:
                    x_m = x_m * (1.0 / input_scale)
            elif inducing == "uniform":
                x_m = x[torch.as_tensor(
                    select_inducing(n, num_inducing, seed), device=device)]
            else:
                x_m = x[_rpchol_indices(spec, x, num_inducing, get, seed,
                                        mesh, mesh_axis, precision)]
            x_m = x_m.contiguous()
        sp.set(m=x_m.shape[0])
        if rank_rtol is None:
            rank_rtol = _default_rank_rtol(x.dtype, moments)
        w_solve, w_kmm = (_laid_out(w, precision) for w in _inducing_bases(
            spec, get, float(rank_rtol), x_m, whiten=whiten,
            device=(finalize == "device" and whiten == "chol"),
            entries=moments))
        c_raw, b_w, m1_w, diag_sum, yty = _stream_moments(
            spec, get, x_m, w_solve, w_kmm, x, y, panel_size, mesh=mesh,
            mesh_axis=mesh_axis, precision=precision)
        if diag_reg_absolute_scale:
            reg = torch.tensor(diag_reg, dtype=x.dtype, device=device)
        else:
            reg = (diag_reg * diag_sum / n).to(x.dtype)
        ic, beta_w = _finalize(c_raw, b_w, reg, x.dtype, finalize)
        return NystromPosterior(
            x_m=x_m, w_solve=w_solve, ic=ic, beta_w=beta_w, reg=reg,
            c_raw=c_raw, b_w=b_w, diag_sum=diag_sum, m1_w=m1_w, w_kmm=w_kmm,
            spec=spec, get=get, diag_reg=diag_reg, num_train=n,
            input_scale=float(input_scale), precision=precision,
            rank_rtol=float(rank_rtol), panel_size=panel_size,
            finalize=finalize, yty=yty, moments=moments, mesh=mesh,
            mesh_axis=mesh_axis)
