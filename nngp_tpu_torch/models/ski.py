"""Structured Kernel Interpolation (SKI / KISS-GP) Deep Kernel Learning.
Port of `nngp_tpu/models/ski.py`.

The kernel is approximated as

    k(x, x') ~= w_x^T K_UU w_x'

with U a Cartesian grid over the 2-d embedding space, K_UU the RBF Gram on
the grid (a Kronecker product of per-dimension 1-d Grams), and w_x cubic
convolution interpolation weights (4 grid points per dimension). The exact
companion model lives in `models/dkl.py`.

  - per-dimension interpolation weights are kept as dense (n, g) matrices,
    so every SKI product is a GEMM;
  - K_UU never materializes: the Kronecker factors (g, g) are applied
    dimension by dimension;
  - solves use matrix-free batched CG and the training loss uses
    stochastic-trace gradients + SLQ log-determinants (`ops/iterative.py`).

Training gradients: d(-MLL)/dtheta = -0.5 a^T dK a + 0.5 tr(K^-1 dK) with
a = K^-1 y; the trace uses Hutchinson probes z_i and solves w_i = K^-1 z_i.
Both solves run outside the autograd graph (detached operator, CG under
no_grad), and a surrogate loss  -0.5 a^T K a + (0.5/m) sum_i w_i^T K z_i
with a and w_i detached reproduces exactly those gradients under autograd.

The interpolation products contract through the right-hand sides first:
(n, h) x (n, b) -> (n, h*b), then one GEMM with the other dimension's
weights. Contracting the two weight matrices first would build an
(n, g, g) tensor on every CG iteration.

The Hutchinson probes are drawn from a `torch.Generator` or given as a
tensor; the same probes serve the trace term and the SLQ log-determinant,
as the JAX module draws both from one key.
"""

import math
from typing import Optional, Tuple

import torch

from nngp_tpu_torch.models.dkl import (Params, _embed, _rescale, adam_train,
                                       hyper, init_dkl_params)
from nngp_tpu_torch.ops.iterative import batched_cg, rademacher, slq_logdet

GRID_SIZE = 100
# embeddings are rescaled to [-1, 1]; the margin keeps the 4-point stencil
# interior
GRID_LO, GRID_HI = -1.1, 1.1


def cubic_interp_matrix(x: torch.Tensor, g: int = GRID_SIZE,
                        lo: float = GRID_LO, hi: float = GRID_HI):
    """Dense (n, g) cubic convolution interpolation matrix for scalar
    coordinates x onto the uniform grid linspace(lo, hi, g).

    Keys' cubic kernel (a = -1/2): reproduces polynomials up to degree 2,
    4 nonzero weights per point."""
    h = (hi - lo) / (g - 1)
    t = (x - lo) / h
    j = torch.clamp(torch.floor(t.detach()).to(torch.int64), 1, g - 3)
    u = t - j                                   # in [0, 1) for interior x

    # stencil distances: |x - grid[j-1..j+2]| / h = 1+u, u, 1-u, 2-u
    def near(s):   # 0 <= s <= 1
        return 1.5 * s ** 3 - 2.5 * s ** 2 + 1.0

    def far(s):    # 1 < s <= 2
        return -0.5 * (s ** 3 - 5.0 * s ** 2 + 8.0 * s - 4.0)

    w = torch.stack([far(1.0 + u), near(u), near(1.0 - u), far(2.0 - u)],
                    dim=-1)                     # (n, 4)
    cols = j[:, None] + torch.arange(-1, 3, device=x.device)[None, :]
    out = torch.zeros((x.shape[0], g), dtype=x.dtype, device=x.device)
    return out.scatter_add(1, cols, w)


def grid_points(g: int = GRID_SIZE, lo: float = GRID_LO,
                hi: float = GRID_HI, dtype=torch.float32, device="cpu"):
    return torch.linspace(lo, hi, g, dtype=dtype, device=device)


def _kuu_1d(grid, lengthscale):
    d = (grid[:, None] - grid[None, :]) / lengthscale
    return torch.exp(-0.5 * d * d)


def interp_weights(z: torch.Tensor, g: int = GRID_SIZE):
    """Per-dimension dense interpolation matrices for embeddings z (n, d)."""
    return [cubic_interp_matrix(z[:, i], g) for i in range(z.shape[1])]


def interp_t_apply(ws, v):
    """U = W^T v lifted onto the grid: (n, b) -> (g1, ..., gd, b)."""
    n, b = v.shape
    sizes = [w.shape[1] for w in ws]
    lifted = v
    for w in reversed(ws[1:]):
        lifted = (w[:, :, None] * lifted[:, None, :]).reshape(n, -1)
    return (ws[0].mT @ lifted).reshape(*sizes, b)


def interp_apply(ws, u):
    """y = W u read off the grid: (g1, ..., gd, b) -> (n, b)."""
    rows = ws[0] @ u.reshape(u.shape[0], -1)
    n = rows.shape[0]
    for w in ws[1:]:
        rows = torch.sum(w[:, :, None] * rows.reshape(n, w.shape[1], -1),
                         dim=1)
    return rows


def kuu_apply(kuu_1ds, u):
    """(K_1 kron ... kron K_d) u, applied factor by factor."""
    for i, k in enumerate(kuu_1ds):
        u = torch.movedim(torch.tensordot(k, u, dims=([1], [i])), 0, i)
    return u


def _ski_parts(params, z, g):
    ls, amp, noise = hyper(params)
    ws = interp_weights(z, g)
    grid = grid_points(g, dtype=z.dtype, device=z.device)
    kuu_1ds = [_kuu_1d(grid, ls[i]) for i in range(z.shape[1])]
    return ws, kuu_1ds, amp, noise


def ski_mvm(ws, kuu_1ds, amp, noise, v):
    """(W K_UU W^T * amp + noise I) v for v (n, b)."""
    return amp * interp_apply(ws, kuu_apply(kuu_1ds, interp_t_apply(ws, v))) \
        + noise * v


def ski_cross_mvm(ws_out, ws_in, kuu_1ds, amp, v):
    """amp * W_out K_UU W_in^T v: cross-covariance product (no noise)."""
    return amp * interp_apply(ws_out,
                              kuu_apply(kuu_1ds, interp_t_apply(ws_in, v)))


def ski_diag(ws, kuu_1ds, amp):
    """diag(amp * W K_UU W^T): per-row quadratic form w^T K_UU w, which for
    w = w1 kron w2 is the product of the per-dimension forms."""
    q = torch.ones(ws[0].shape[0], dtype=ws[0].dtype, device=ws[0].device)
    for wi, ki in zip(ws, kuu_1ds):
        q = q * torch.sum(wi * (wi @ ki.mT), dim=1)
    return amp * q


def neg_mll_ski(params: Params, x, y,
                generator: Optional[torch.Generator] = None, *,
                probes: Optional[torch.Tensor] = None,
                grid_size=GRID_SIZE, num_probes=8, cg_tol=1e-5, cg_iters=256,
                slq_iters=20):
    """Surrogate -MLL whose autograd gradient equals the stochastic-trace
    KISS-GP gradient (see module docstring). The returned value is the SLQ
    estimate of the true -MLL (reported for monitoring; its own gradient
    path is cut). The (n, num_probes) +-1 probes come from `generator`
    unless given."""
    n = x.shape[0]
    z = _rescale(_embed(params, x))
    dt = z.dtype
    ws, kuu_1ds, amp, noise = _ski_parts(params, z, grid_size)
    ws_ng = [w.detach() for w in ws]
    kuu_ng = [k.detach() for k in kuu_1ds]
    amp_ng, noise_ng = amp.detach(), noise.detach()

    def mvm_nograd(v):
        return ski_mvm(ws_ng, kuu_ng, amp_ng, noise_ng, v)

    yc = (y.reshape(-1, 1) - params["mean_const"]).to(dt)
    if probes is None:
        if generator is None:
            raise ValueError("neg_mll_ski needs a generator or the probes")
        probes = rademacher((n, num_probes), generator, dt)
    probes = probes.to(device=z.device, dtype=dt)
    num_probes = probes.shape[1]
    rhs = torch.cat([yc.detach(), probes], dim=1)
    sol = batched_cg(mvm_nograd, rhs, tol=cg_tol, max_iters=cg_iters)
    alpha, wprobes = sol[:, :1], sol[:, 1:]

    def mvm_grad(v):
        return ski_mvm(ws, kuu_1ds, amp, noise, v)

    # gradient-carrying surrogate terms. For -MLL = 0.5 yc^T K^-1 yc
    # + 0.5 logdet K + const:
    #   d/dtheta (0.5 yc^T K^-1 yc) = -0.5 a^T (dK) a
    #       -> surrogate term  -0.5 a^T K(theta) a, a detached
    #   d/dc    (0.5 yc^T K^-1 yc) = -sum(a)   (yc = y - c)
    #       -> surrogate term  a^T yc(c)
    #   d/dtheta (0.5 logdet K)    ~= 0.5/m sum_i w_i^T (dK) z_i
    #       -> surrogate term  0.5/m sum_i w_i^T K(theta) z_i, w_i detached
    data_term = -0.5 * torch.sum(alpha * mvm_grad(alpha)) \
        + torch.sum(alpha * yc)
    trace_term = 0.5 / num_probes * torch.sum(wprobes * mvm_grad(probes))
    surrogate = data_term + trace_term

    # monitored value: true -MLL estimate, gradient path cut
    logdet = slq_logdet(mvm_nograd, n, probes=probes, num_iters=slq_iters,
                        dtype=dt)
    value = (0.5 * torch.sum(yc.detach() * alpha) + 0.5 * logdet
             + 0.5 * n * math.log(2.0 * math.pi))
    return surrogate - surrogate.detach() + value


def train_dkl_ski(x_train, y_train, hid_dim=256, epochs=40, lr=0.01,
                  seed=0, grid_size=GRID_SIZE, num_probes=8, verbose=None,
                  device="cuda", init: Optional[Params] = None) -> Params:
    """Joint Adam training of extractor + ARD-RBF + noise + constant mean
    with the grid-interpolation covariance, in fp32 on `device`. The init
    comes from `seed` and each epoch's probes from a generator seeded with
    seed + 1; `init` replaces the seeded initial parameters and then sets
    the dtype."""
    from nngp_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    x = torch.as_tensor(x_train, device=device)
    if init is None:
        init = init_dkl_params(torch.Generator().manual_seed(seed),
                               x.shape[1], hid_dim, device=device)
    dtype = init["w1"].dtype
    x = x.to(dtype)
    y = torch.as_tensor(y_train, dtype=dtype, device=device)
    probe_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def loss_fn(p, _epoch):
        return neg_mll_ski(p, x, y, probe_gen, grid_size=grid_size,
                           num_probes=num_probes)

    return adam_train(init, loss_fn, epochs, lr, verbose, "SKI-DKL")


@torch.no_grad()
def predict_dkl_ski(params: Params, x_train, y_train, x_test, *,
                    grid_size=GRID_SIZE, cg_tol=1e-5, cg_iters=256,
                    var_chunk=512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/std at x_test under the SKI covariance.

    mean = k*^T K^-1 (y - c) + c;  var = diag(k**) - diag(k*^T K^-1 k*),
    with every k-product a SKI product and every solve a batched CG. The
    variance solves run in chunks of var_chunk test columns."""
    dev, pdt = params["w1"].device, params["w1"].dtype
    x = torch.as_tensor(x_train, dtype=pdt, device=dev)
    xt = torch.as_tensor(x_test, dtype=pdt, device=dev)
    y = torch.as_tensor(y_train, dtype=pdt, device=dev)
    n, m = x.shape[0], xt.shape[0]
    zj = _rescale(_embed(params, torch.cat([x, xt], dim=0)), None)
    z, zt = zj[:n], zj[n:]
    dt = zj.dtype
    ws, kuu_1ds, amp, noise = _ski_parts(params, z, grid_size)
    ws_t = interp_weights(zt, grid_size)

    def mvm(v):
        return ski_mvm(ws, kuu_1ds, amp, noise, v)

    yc = y.reshape(-1, 1) - params["mean_const"]
    alpha = batched_cg(mvm, yc, tol=cg_tol, max_iters=cg_iters)
    mean = ski_cross_mvm(ws_t, ws, kuu_1ds, amp, alpha).ravel() \
        + params["mean_const"]

    # variance: chunked CG on the cross-covariance columns
    kss = ski_diag(ws_t, kuu_1ds, amp)
    var = torch.zeros((m,), dtype=dt, device=dev)
    for s in range(0, m, var_chunk):
        e = min(s + var_chunk, m)
        ws_chunk = [w[s:e] for w in ws_t]
        kstar = ski_cross_mvm(ws, ws_chunk, kuu_1ds, amp,
                              torch.eye(e - s, dtype=dt, device=dev))
        sol = batched_cg(mvm, kstar, tol=cg_tol, max_iters=cg_iters)
        var[s:e] = kss[s:e] - torch.sum(kstar * sol, dim=0)
    return mean, torch.sqrt(var.clamp_min(0.0))
