"""The exact GP posterior in plain PyTorch: the reference for the exact
tier's served answers.

    K = k(X, X) + r I,  r = diag_reg * mean(diag k(X, X)),  K = L L^T
    mean(x*) = k(x*, X) K^-1 y,  var(x*) = k(x*, x*) - |L^-1 k(X, x*)|^2

Nothing here imports the program: the features come from the benchmark's
own encoder, the kernel from `reference.kernel`.
"""

import torch

from portbench.reference import kernel


class ExactPosterior:
    def __init__(self, layers, x, y, diag_reg):
        """x (n, d), y (n,) tensors on the device, in the dtype to work
        in."""
        self.layers, self.x = layers, x
        k = kernel.sym(layers, x)
        r = diag_reg * torch.mean(kernel.diag(layers, x))
        k.diagonal().add_(r)
        self.l = torch.linalg.cholesky(k)
        del k
        self.alpha = torch.cholesky_solve(y.reshape(-1, 1), self.l)

    def predict(self, xs, block=2048):
        """(mean, std) of the rows xs, each (len(xs),)."""
        means, stds = [], []
        for s in range(0, xs.shape[0], block):
            xb = xs[s:s + block]
            kc = kernel.cross(self.layers, xb, self.x)
            means.append((kc @ self.alpha).reshape(-1))
            v = torch.linalg.solve_triangular(self.l, kc.mT, upper=False)
            var = kernel.diag(self.layers, xb) - torch.sum(v * v, dim=0)
            stds.append(torch.sqrt(torch.clamp_min(var, 0.0)))
        return torch.cat(means), torch.cat(stds)


def fit(config, x, y):
    """The exact posterior of rows x (n, d) and labels y (n,), tensors on
    the device in the dtype to work in, under the configuration's kernel
    and diag_reg."""
    return ExactPosterior(config["kernel"], x, y, config["diag_reg"])


def predict(config, state, xs):
    """(mean, std) of the rows xs."""
    return state.predict(xs)
