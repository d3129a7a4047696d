"""Deep Kernel Learning baseline, exact GP. Port of `nngp_tpu/models/dkl.py`.

An MLP feature extractor projects inputs to 2 dims (min-max rescaled to
[-1, 1]), and an RBF GP with constant mean is trained by maximizing the
exact marginal likelihood jointly over extractor + kernel + likelihood
parameters with Adam. The grid-interpolation variant is `models/ski.py`.

The parameters are a flat dict of tensors under the JAX module's names
(w1 (in, hid), b1, w2 (hid, 2), b2, raw_lengthscale (2,), raw_amp,
raw_noise, mean_const), so a JAX parameter dict carries across as it is.

Gradient ties follow the JAX module: `_rescale` differentiates through the
column min and max with `amin` / `amax` (the gradient is split evenly among
tied rows, as JAX splits it; `torch.min(dim=)` would pick one), and the ReLU
and the distance clamp are `torch.maximum(., 0)` (half the gradient at a
tie, as `jnp.maximum`).
"""

import math
from typing import Dict, Optional, Tuple

import torch

from nngp_tpu_torch.models.gp_rbf import cholesky, softplus

Params = Dict[str, torch.Tensor]


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _embed(params, x):
    h = x @ params["w1"] + params["b1"]
    h = torch.maximum(h, _zero(h))
    return h @ params["w2"] + params["b2"]   # (n, 2)


def _rescale(z, ref=None):
    """[-1, 1] min-max rescale of embeddings z with stats taken from ref
    (defaults to z itself). Train and test must share one coordinate frame:
    normalizing each batch independently maps identical inputs to different
    coordinates under distribution shift, so `predict_dkl` rescales the
    concatenated train + test batch jointly."""
    if ref is None:
        ref = z
    lo = torch.amin(ref, dim=0)
    z = z - lo
    span = torch.amax(ref - lo, dim=0)
    return 2.0 * (z / span.clamp_min(1e-12)) - 1.0


def _extract(params, x, stats_from=None):
    """MLP feature extractor + [-1, 1] min-max rescale (stats from
    `stats_from`, defaulting to x itself)."""
    z = _embed(params, x)
    ref = z if stats_from is None else _embed(params, stats_from)
    return _rescale(z, ref)


def _rbf_gram(z1, z2, lengthscale, amp):
    zs1, zs2 = z1 / lengthscale, z2 / lengthscale
    d = (torch.sum(zs1 ** 2, 1)[:, None] + torch.sum(zs2 ** 2, 1)[None, :]
         - 2.0 * zs1 @ zs2.mT)
    return amp * torch.exp(-0.5 * torch.maximum(d, _zero(d)))


def init_dkl_params(generator: torch.Generator, in_dim: int,
                    hid_dim: int = 256, out_dim: int = 2,
                    dtype=torch.float32, device="cpu") -> Params:
    """Uniform +-1/sqrt(fan_in) weights drawn from `generator` (a CPU
    generator: the same seed gives the same init on every device), zero
    biases, and the JAX module's constants for the GP's raw parameters."""
    s1 = 1.0 / math.sqrt(in_dim)
    s2 = 1.0 / math.sqrt(hid_dim)

    def uniform(shape, s):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return ((2.0 * u - 1.0) * s).to(device)

    def const(shape, value=0.0):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "w1": uniform((in_dim, hid_dim), s1),
        "b1": const((hid_dim,)),
        "w2": uniform((hid_dim, out_dim), s2),
        "b2": const((out_dim,)),
        "raw_lengthscale": const((out_dim,)),
        "raw_amp": const(()),
        "raw_noise": const((), -2.0),
        "mean_const": const(()),
    }


def hyper(params):
    """(lengthscale (2,), amplitude, noise), softplus-constrained."""
    ls = softplus(params["raw_lengthscale"]) + 1e-4
    amp = softplus(params["raw_amp"]) + 1e-4
    noise = softplus(params["raw_noise"]) + 1e-4
    return ls, amp, noise


def neg_mll(params: Params, x, y) -> torch.Tensor:
    z = _extract(params, x)
    ls, amp, noise = hyper(params)
    n = x.shape[0]
    k = _rbf_gram(z, z, ls, amp) + noise * torch.eye(n, dtype=z.dtype,
                                                     device=z.device)
    chol = cholesky(k, "dkl")
    yc = y.ravel() - params["mean_const"]
    kinvy = torch.cholesky_solve(yc[:, None], chol)[:, 0]
    return (0.5 * torch.dot(yc, kinvy)
            + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2.0 * math.pi))


def adam_train(params: Params, loss_fn, epochs: int, lr: float,
               verbose, label: str) -> Params:
    """Full-batch Adam (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, as
    `optax.adam(lr)`) over a flat parameter dict; loss_fn(leaves, epoch)
    returns the loss. The loss is read back once per epoch, when verbose."""
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for i in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(leaves, i)
        loss.backward()
        opt.step()
        if verbose:
            verbose(f"{i}-th Epochs: {label} Train Loss={float(loss.detach()):.4f}")
    return {k: p.detach() for k, p in leaves.items()}


def train_dkl(x_train, y_train, hid_dim=256, epochs=40, lr=0.01, seed=0,
              verbose=None, device="cuda",
              init: Optional[Params] = None) -> Params:
    """Joint Adam training on `device`, in fp32; `init` replaces the seeded
    initial parameters (to carry another implementation's across) and
    then sets the dtype."""
    from nngp_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    x = torch.as_tensor(x_train, device=device)
    if init is None:
        init = init_dkl_params(torch.Generator().manual_seed(seed),
                               x.shape[1], hid_dim, device=device)
    dtype = init["w1"].dtype
    x = x.to(dtype)
    y = torch.as_tensor(y_train, dtype=dtype, device=device)
    return adam_train(init, lambda p, _i: neg_mll(p, x, y), epochs, lr,
                      verbose, "DKL")


@torch.no_grad()
def predict_dkl(params: Params, x_train, y_train,
                x_test) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/std at x_test. Train and test are embedded once as
    one concatenated batch, whose min/max define the coordinate frame."""
    x = torch.as_tensor(x_train, dtype=params["w1"].dtype,
                        device=params["w1"].device)
    xt = torch.as_tensor(x_test, dtype=x.dtype, device=x.device)
    y = torch.as_tensor(y_train, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    zj = _rescale(_embed(params, torch.cat([x, xt], dim=0)), None)
    z, zt = zj[:n], zj[n:]
    ls, amp, noise = hyper(params)
    k = _rbf_gram(z, z, ls, amp) + noise * torch.eye(n, dtype=z.dtype,
                                                     device=z.device)
    chol = cholesky(k, "dkl predict")
    yc = y.ravel() - params["mean_const"]
    kinvy = torch.cholesky_solve(yc[:, None], chol)[:, 0]
    cross = _rbf_gram(zt, z, ls, amp)
    mean = cross @ kinvy + params["mean_const"]
    v = torch.linalg.solve_triangular(chol, cross.mT, upper=False)
    var = amp - torch.sum(v * v, dim=0)
    return mean, torch.sqrt(var.clamp_min(0.0))
