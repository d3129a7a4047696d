"""Matrix-free iterative linear algebra: batched CG and stochastic Lanczos
quadrature (SLQ) log-determinants. Port of `nngp_tpu/ops/iterative.py`.

The machinery behind the structured-kernel (SKI / KISS-GP) deep-kernel
baseline (`models/ski.py`). The operator is any `mvm(v)` closure over torch
ops, on whatever device its tensors live. JAX's `lax.while_loop` /
`lax.fori_loop` are Python loops here; CG keeps JAX's stopping rule, checked
every iteration, so the iteration counts agree (one host read per
iteration). All three functions run under `torch.no_grad()`: the callers
differentiate a surrogate, never the iterations.

Numerics: everything runs in the operand dtype. Lanczos uses full
reorthogonalization against the kept basis (t <= ~30 vectors); without it
fp32 Lanczos loses orthogonality within a dozen steps and the Ritz values
double up.
"""

from typing import Callable, Optional

import torch


def rademacher(shape, generator: torch.Generator, dtype) -> torch.Tensor:
    """+-1 with equal probability, drawn on the generator's device."""
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


@torch.no_grad()
def batched_cg(mvm: Callable, b: torch.Tensor, *, tol: float = 1e-6,
               max_iters: int = 200) -> torch.Tensor:
    """Solve A x = b for SPD matrix-free A, all RHS columns at once.

    mvm: (n, k) -> (n, k) applying A to each column.
    b:   (n, k) right-hand sides.
    Stops when every column's relative residual is under tol, or at
    max_iters.
    """
    rs = torch.sum(b * b, dim=0)
    b_norm2 = rs.clamp_min(1e-30)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    it = 0
    while it < max_iters and float(torch.max(rs / b_norm2)) > tol * tol:
        ap = mvm(p)
        # per-column step size; guard a converged column's 0/0
        denom = torch.sum(p * ap, dim=0)
        alpha = rs / torch.where(denom > 0, denom, torch.ones_like(denom))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = torch.sum(r * r, dim=0)
        beta = rs_new / torch.where(rs > 0, rs, torch.ones_like(rs))
        p = r + beta[None, :] * p
        rs = rs_new
        it += 1
    return x


@torch.no_grad()
def batched_lanczos(mvm: Callable, q0: torch.Tensor, num_iters: int):
    """Batched Lanczos: tridiagonalize A in the Krylov space of each probe
    column of q0 (n, m), with full reorthogonalization.

    Returns (alphas (t, m), betas (t-1, m), q_norm (m,)): per-probe
    tridiagonal coefficients and the initial probe norms."""
    n, m = q0.shape
    t = num_iters
    q_norm = torch.sqrt(torch.sum(q0 * q0, dim=0))
    q_cur = q0 / q_norm[None, :].clamp_min(1e-30)
    basis = torch.zeros((t + 1, n, m), dtype=q0.dtype, device=q0.device)
    basis[0] = q_cur
    alphas = torch.zeros((t, m), dtype=q0.dtype, device=q0.device)
    betas = torch.zeros((t, m), dtype=q0.dtype, device=q0.device)
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((m,), dtype=q0.dtype, device=q0.device)
    for i in range(t):
        w = mvm(q_cur)
        alpha = torch.sum(q_cur * w, dim=0)
        w = w - alpha[None, :] * q_cur - beta_prev[None, :] * q_prev
        # full reorthogonalization against every vector kept so far
        kept = basis[:i + 1]
        coeffs = torch.einsum("tnm,nm->tm", kept, w)
        w = w - torch.einsum("tnm,tm->nm", kept, coeffs)
        beta = torch.sqrt(torch.sum(w * w, dim=0).clamp_min(0.0))
        q_next = w / beta[None, :].clamp_min(1e-30)
        alphas[i] = alpha
        betas[i] = beta
        basis[i + 1] = q_next
        q_prev, q_cur, beta_prev = q_cur, q_next, beta
    return alphas, betas[:-1], q_norm


@torch.no_grad()
def slq_logdet(mvm: Callable, n: int,
               generator: Optional[torch.Generator] = None, *,
               probes: Optional[torch.Tensor] = None, num_probes: int = 16,
               num_iters: int = 25,
               dtype=torch.float32) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of logdet(A) for SPD
    matrix-free A of size n x n.

    E_z[z^T log(A) z] = tr(log A) = logdet(A) with Rademacher probes z;
    each quadratic form is evaluated by t Lanczos steps + an eigensolve of
    the t x t tridiagonal (Golub-Welsch quadrature). Relative error is
    typically ~1% at 16 probes / 25 iters for kernel-plus-ridge spectra.

    The probes are drawn from `generator` (on its device), or given as an
    (n, num_probes) tensor of +-1 so that two implementations can share
    them.
    """
    if probes is None:
        if generator is None:
            raise ValueError("slq_logdet needs a generator or the probes")
        probes = rademacher((n, num_probes), generator, dtype)
    z = probes.to(dtype)
    alphas, betas, q_norm = batched_lanczos(mvm, z, num_iters)
    # per-probe tridiagonal (m, t, t)
    tri = (torch.diag_embed(alphas.T)
           + torch.diag_embed(betas.T, offset=1)
           + torch.diag_embed(betas.T, offset=-1))
    evals, evecs = torch.linalg.eigh(tri)
    # quadrature: z^T log(A) z ~ |z|^2 * sum_j (e1^T v_j)^2 log(lambda_j).
    # A is SPD but fp32 Lanczos can leak tiny negative Ritz values: clamp.
    tau2 = evecs[:, 0, :] ** 2                       # (m, t)
    logs = torch.log(evals.clamp_min(1e-30))
    quad = torch.sum(tau2 * logs, dim=1) * q_norm ** 2
    return torch.mean(quad)
