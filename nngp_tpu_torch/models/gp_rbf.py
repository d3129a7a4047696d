"""Trainable RBF (exponentiated-quadratic) GP baseline. Port of
`nngp_tpu/models/gp_rbf.py`: the `--kernel_type gp` path of the training CLI
and the `RBF-GP` baseline.

Softplus-constrained amplitude / noise / lengthscale, exact MLL via Cholesky,
lognormal amplitude prior, an RMSProp-with-momentum hyperparameter loop (10
steps, lr 0.01), posterior mean and full covariance with the train-mean
offset. Deterministic: the init is three constants and nothing is sampled.

Kept as the JAX module writes them, because the results are held to its
numbers: 3.1415 for pi and the prior term as written; `exp(-d)` with no
1/2; the optimizer is written by hand (`0.9 m + 0.1 g`, `sqrt(s + 1e-5)`,
scales start at 1), it is not `torch.optim.RMSprop`. `torch.maximum(d, 0)`
passes half the gradient at a tie (the Gram's diagonal, where d is 0 up to
rounding), as `jnp.maximum` does; `clamp(min=0)` would pass all of it.

The Gram is factored in the working dtype with no jitter beyond the 1e-6 the
JAX module adds; a factorization that fails raises.
"""

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no linear cut-over (F.softplus switches to x above
    a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def cholesky(k: torch.Tensor, what: str) -> torch.Tensor:
    """Lower Cholesky factor of k; raises when k is not positive definite in
    its dtype (no jitter is added)."""
    chol, info = torch.linalg.cholesky_ex(k)
    info = int(info)
    if info != 0:
        raise RuntimeError(
            f"{what}: the Cholesky factorization of the {k.shape[0]} x "
            f"{k.shape[0]} {str(k.dtype)[6:]} Gram failed at leading minor "
            f"{info}")
    return chol


def _sq_dists(x1, x2):
    """Pairwise squared distances as a matmul + broadcasts."""
    n1 = torch.sum(x1 * x1, dim=1)[:, None]
    n2 = torch.sum(x2 * x2, dim=1)[None, :]
    d = n1 + n2 - 2.0 * (x1 @ x2.mT)
    return torch.maximum(d, torch.zeros((), dtype=d.dtype, device=d.device))


def init_params(dtype=torch.float32, device="cpu") -> Params:
    return {
        "amplitude": torch.zeros((1, 1), dtype=dtype, device=device),
        "noise": torch.zeros((1, 1), dtype=dtype, device=device) - 5.0,
        "lengthscale": torch.zeros((1, 1), dtype=dtype, device=device),
    }


def _gp_core(params, x, y):
    noise = softplus(params["noise"])
    amp = softplus(params["amplitude"])
    ls = softplus(params["lengthscale"])
    ymean = torch.mean(y)
    yc = y - ymean
    xs = x / ls
    n = x.shape[0]
    train_cov = (amp * torch.exp(-_sq_dists(xs, xs))
                 + torch.eye(n, dtype=x.dtype, device=x.device)
                 * (noise + 1e-6))
    chol = cholesky(train_cov, "gp_rbf")
    kinvy = torch.cholesky_solve(yc, chol)
    return noise, amp, ls, ymean, yc, xs, chol, kinvy


def neg_marginal_likelihood(params: Params, x, y) -> torch.Tensor:
    """Negative MLL + lognormal amplitude prior; x (n, d), y (n, 1)."""
    noise, amp, ls, ymean, yc, xs, chol, kinvy = _gp_core(params, x, y)
    n = x.shape[0]
    log2pi = torch.log(torch.tensor(2.0 * 3.1415, dtype=x.dtype,
                                    device=x.device))
    ml = (-0.5 * torch.sum(yc * kinvy)
          - torch.sum(torch.log(torch.diagonal(chol)))
          - (n / 2.0) * log2pi)
    ml = ml - torch.sum(-0.5 * log2pi - torch.log(amp) ** 2)
    return -ml


def train_step(params: Params, momentums: Params, scales: Params, x, y,
               lr: float):
    """One RMSProp-with-momentum step; returns the new (params, momentums,
    scales)."""
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in params.items()}
    loss = neg_marginal_likelihood(leaves, x, y)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    new_p, new_m, new_s = {}, {}, {}
    for k in params:
        g = grads[k]
        new_m[k] = 0.9 * momentums[k] + 0.1 * g
        new_s[k] = 0.9 * scales[k] + 0.1 * g ** 2
        new_p[k] = params[k] - lr * new_m[k] / torch.sqrt(new_s[k] + 1e-5)
    return new_p, new_m, new_s


def train(x, y, num_steps: int = 10, lr: float = 0.01,
          verbose=print) -> Params:
    """Hyperparameters after num_steps steps from the constant init, on x's
    device and in its dtype."""
    params = init_params(x.dtype, x.device)
    momentums = {k: torch.zeros_like(p) for k, p in params.items()}
    scales = {k: torch.ones_like(p) for k, p in params.items()}
    for i in range(num_steps):
        params, momentums, scales = train_step(params, momentums, scales,
                                               x, y, lr)
        if verbose:
            with torch.no_grad():
                ml = neg_marginal_likelihood(params, x, y)
            verbose(f"Step: {i}, neg marginal likelihood: {float(ml):f}")
    return params


@torch.no_grad()
def predict(params: Params, x, y, x_test) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Posterior mean (m, 1) and full covariance (m, m)."""
    noise, amp, ls, ymean, yc, xs, chol, kinvy = _gp_core(params, x, y)
    xt = x_test / ls
    cross = amp * torch.exp(-_sq_dists(xs, xt))          # (n, m)
    mu = cross.mT @ kinvy + ymean
    v = torch.linalg.solve_triangular(chol, cross, upper=False)
    var = amp * torch.exp(-_sq_dists(xt, xt)) - v.mT @ v
    return mu, var
