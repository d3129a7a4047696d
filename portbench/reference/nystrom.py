"""The Nystrom (DTC) posterior in plain PyTorch: the reference for the
Nystrom tier's fits.

With m inducing rows X_m (a seeded uniform subset of the n rows, sorted:
`numpy.random.default_rng(seed).choice(n, m, replace=False)`), the
whitening basis W = chol(K_mm + j I)^-T with the jitter
j = rank_rtol * lambda_max(K_mm) (raised 10x while the factor fails),
psi = W^T K_mn, C = psi psi^T, b = psi y and the relative ridge
r = diag_reg * mean(diag K):

    ic ic^T = (C + r I)^-1,  beta = ic ic^T b
    mean(x*) = psi*^T beta,
    var(x*) = k(x*, x*) - |psi*|^2 + r |ic^T psi*|^2,  psi* = W^T k_m*

(Titsias 2009; Quinonero-Candela and Rasmussen 2005, the DTC predictive
with the exact prior diagonal.) W, the k x k factor and beta are computed
in fp64 always; the kernel entries and the three products in `dtype`,
with TF32 products when `tf32` is set (the lower-precision control:
both operands rounded to TF32, then multiplied in fp32).
"""

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import kernel


def inducing_indices(n, m, seed):
    if m >= n:
        return np.arange(n)
    return np.sort(np.random.default_rng(seed).choice(n, size=m,
                                                      replace=False))


def _chol_inverse_t(a, jitter):
    """chol(a + jitter I)^-T, the jitter raised 10x while it fails."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    for _ in range(12):
        ell, info = torch.linalg.cholesky_ex(a + jitter * eye)
        if int(info) == 0:
            return torch.linalg.solve_triangular(ell, eye, upper=False).mT
        jitter *= 10.0
    raise torch.linalg.LinAlgError("K_mm not factorizable")


def tf32_round(t):
    """fp32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), as the tensor cores read their operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, tf32):
    """a @ b; with tf32 both operands rounded to TF32 first, then
    multiplied and summed in fp32 (TF32 products, on any device)."""
    if tf32:
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def fit(config, x, y, dtype=torch.float64, tf32=False, w=None, scale=1.0):
    """The posterior state (x_m, w_solve, ic, beta_w, reg, input_scale) of
    rows x (n, d) and labels y (n,), tensors on the device, under the
    configuration's kernel, num_inducing, inducing_seed, rank_rtol,
    diag_reg and panel_rows.

    w: a whitening basis to take in place of the reference's own, and
    scale: the divisor of the inputs (a fit's prescale): the moments'
    check, which takes a program's fit on from its basis. The state also
    keeps the moments C (c_raw) and b (b_w) in `dtype`."""
    layers, m = config["kernel"], config["num_inducing"]
    n = x.shape[0]
    x = (x.to(torch.float64) / scale).to(dtype)
    y = y.to(dtype).reshape(-1, 1)
    idx = torch.as_tensor(inducing_indices(n, m, config["inducing_seed"]),
                          device=x.device)
    x_m = x[idx].contiguous()
    if w is None:
        kmm = kernel.cross(layers, x_m, x_m).to(torch.float64)
        kmm = 0.5 * (kmm + kmm.mT)
        lam_max = float(torch.linalg.eigvalsh(kmm)[-1])
        w = _chol_inverse_t(kmm, config["rank_rtol"] * lam_max)
    w = w.to(dtype)
    k = w.shape[1]
    c = torch.zeros((k, k), dtype=dtype, device=x.device)
    b = torch.zeros((k, 1), dtype=dtype, device=x.device)
    dsum = torch.zeros((), dtype=torch.float64, device=x.device)
    panel = config["panel_rows"]
    for s in range(0, n, panel):
        xp = x[s:s + panel]
        psi = _mm(kernel.cross(layers, xp, x_m), w, tf32)       # (p, k)
        c += _mm(psi.mT, psi, tf32)
        b += _mm(psi.mT, y[s:s + panel], tf32)
        dsum += torch.sum(kernel.diag(layers, xp).to(torch.float64))
    reg = config["diag_reg"] * dsum / n
    ic, beta = finalize(c, b, reg)
    return SimpleNamespace(x_m=x_m, w_solve=w, ic=ic, beta_w=beta, reg=reg,
                           c_raw=c, b_w=b, input_scale=float(scale))


def finalize(c, b, reg):
    """(ic, beta) in fp64 of the moments C (k, k), b (k, 1) and the ridge
    r: ic ic^T = (C + r I)^-1 by Cholesky, beta = ic ic^T b."""
    f64 = torch.float64
    c64 = c.to(f64)
    c64 = 0.5 * (c64 + c64.mT)
    eye = torch.eye(c64.shape[0], dtype=f64, device=c64.device)
    ic = torch.linalg.solve_triangular(
        torch.linalg.cholesky(c64 + float(reg) * eye), eye, upper=False).mT
    return ic, ic @ (ic.mT @ b.to(f64).reshape(-1, 1))


def whiten_residual(config, x, state):
    """How far a fit's whitening basis W lies from whitening K_mm:
    max |L L^T - K_mm - j I| / max |K_mm|, L = (W^T)^-1, K_mm the fp64
    kernel of the reference's own inducing rows of x (n, d) divided by the
    state's input scale, j the reference's jitter (rank_rtol lambda_max).
    A sound basis reads K_mm's rounding in its dtype; a basis of other
    rows, or of no factor of K_mm, reads order 1."""
    f64 = torch.float64
    idx = torch.as_tensor(inducing_indices(x.shape[0], config["num_inducing"],
                                           config["inducing_seed"]),
                          device=x.device)
    x_m = x[idx].to(f64) / float(state.input_scale)
    kmm = kernel.cross(config["kernel"], x_m, x_m)
    kmm = 0.5 * (kmm + kmm.mT)
    w = state.w_solve.to(f64)
    eye = torch.eye(w.shape[0], dtype=f64, device=x.device)
    ell = torch.linalg.solve(w.mT, eye)
    jitter = config["rank_rtol"] * float(torch.linalg.eigvalsh(kmm)[-1])
    resid = ell @ ell.mT - kmm - jitter * eye
    return float(torch.max(torch.abs(resid)) / torch.max(torch.abs(kmm)))


def predict(config, state, xs, block=4096):
    """(mean, std) in fp64 of the rows xs under a Nystrom posterior state
    (x_m, w_solve, ic, beta_w, reg, input_scale): the reference's own, or
    a fit of the program's, read only to judge it."""
    layers = config["kernel"]
    f64 = torch.float64
    scale = float(state.input_scale)
    x_m = state.x_m.to(f64)
    w = state.w_solve.to(f64)
    ic = state.ic.to(f64)
    beta = state.beta_w.to(f64).reshape(-1, 1)
    reg = float(state.reg)
    means, stds = [], []
    for s in range(0, xs.shape[0], block):
        xb = xs[s:s + block].to(f64) / scale
        psi = kernel.cross(layers, xb, x_m) @ w
        h = psi @ ic
        var = (kernel.diag(layers, xb) - torch.sum(psi * psi, dim=1)
               + reg * torch.sum(h * h, dim=1))
        means.append((psi @ beta).reshape(-1))
        stds.append(torch.sqrt(torch.clamp_min(var, 0.0)) * scale)
    return torch.cat(means), torch.cat(stds)
