"""The exact GP posterior in plain PyTorch, its factor kept as column
blocks: the reference for the exact tier at sizes whose dense n x n
matrices do not fit the card beside their factor.

    K = k(X, X) + r I,  r = diag_reg * mean(diag k(X, X)),  K = L L^T
    mean(x*) = k(x*, X) K^-1 y,  var(x*) = k(x*, x*) - |L^-1 k(X, x*)|^2

The factor is a list of column blocks BLOCK columns wide, block j the
(n - s_j, w_j) tensor L[s_j:, s_j:e_j], computed left-looking: block k's
panel K[s:, s:e] is built from `reference.kernel`'s equations (the exact
diagonal and the ridge on its square), each finished block's product
subtracted, its square factored by `torch.linalg.cholesky` and the rows
below solved against it. ~n^2/2 elements: at n = 90,000 in fp64 the
factor takes ~33 GB, and K + rI never exists. alpha and the probe rows'
variances come by block forward and back substitution. TF32 is switched
off for every product. Nothing here imports the program.
"""

import torch

from portbench.reference import kernel

# columns of a block of the factor, and rows of a panel built or updated
# at a time (each bounds a temporary to (ROWS, BLOCK) beside the factor)
BLOCK = 4096
ROWS = 16384


def _forward(blocks, starts, b):
    """L^-1 b in place on b (n, k), by blocks."""
    for s, e, blk in zip(starts, starts[1:], blocks):
        w = e - s
        b[s:e] = torch.linalg.solve_triangular(blk[:w], b[s:e], upper=False)
        b[e:] -= blk[w:] @ b[s:e]
    return b


def _backward(blocks, starts, b):
    """L^-T b in place on b (n, k), by blocks."""
    for s, e, blk in reversed(list(zip(starts, starts[1:], blocks))):
        w = e - s
        b[s:e] -= blk[w:].mT @ b[e:]
        b[s:e] = torch.linalg.solve_triangular(blk[:w].mT, b[s:e],
                                               upper=True)
    return b


class ExactBlocksPosterior:
    def __init__(self, layers, x, y, diag_reg):
        """x (n, d), y (n,) tensors on the device, in the dtype to work
        in."""
        self.layers, self.x = layers, x
        n = x.shape[0]
        dx = torch.sum(x * x, dim=1) / x.shape[1]
        diag = kernel.diag(layers, x)
        r = diag_reg * torch.mean(diag)
        self.starts = list(range(0, n, BLOCK)) + [n]
        self.blocks = []
        for s, e in zip(self.starts, self.starts[1:]):
            w = e - s
            panel = x.new_empty((n - s, w))
            for a in range(s, n, ROWS):
                panel[a - s:a - s + ROWS] = kernel.cross(
                    layers, x[a:a + ROWS], x[s:e], dx[a:a + ROWS], dx[s:e])
            panel[:w].diagonal().copy_(diag[s:e] + r)
            for js, blk in zip(self.starts, self.blocks):
                top = blk[s - js:e - js]
                for a in range(s, n, ROWS):
                    panel[a - s:a - s + ROWS] -= (blk[a - js:a - js + ROWS]
                                                  @ top.mT)
            lkk = torch.linalg.cholesky(panel[:w])
            panel[w:] = torch.linalg.solve_triangular(lkk.mT, panel[w:],
                                                      upper=True, left=False)
            panel[:w] = lkk
            self.blocks.append(panel)
        self.alpha = _backward(self.blocks, self.starts,
                               _forward(self.blocks, self.starts,
                                        y.reshape(-1, 1).clone()))

    def predict(self, xs, block=2048):
        """(mean, std) of the rows xs, each (len(xs),)."""
        means, stds = [], []
        for s in range(0, xs.shape[0], block):
            xb = xs[s:s + block]
            kc = kernel.cross(self.layers, self.x, xb)          # (n, b)
            means.append((kc.mT @ self.alpha).reshape(-1))
            v = _forward(self.blocks, self.starts, kc)
            var = kernel.diag(self.layers, xb) - torch.sum(v * v, dim=0)
            stds.append(torch.sqrt(torch.clamp_min(var, 0.0)))
        return torch.cat(means), torch.cat(stds)


def fit(config, x, y):
    """The exact posterior of rows x (n, d) and labels y (n,), tensors on
    the device in the dtype to work in, under the configuration's kernel
    and diag_reg."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ExactBlocksPosterior(config["kernel"], x, y, config["diag_reg"])


def predict(config, state, xs):
    """(mean, std) of the rows xs."""
    return state.predict(xs)
