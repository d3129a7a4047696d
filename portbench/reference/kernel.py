"""The NNGP kernel of a serial Dense / activation stack, in plain PyTorch.

The closed form of the infinite-width network (Neal 1996; Lee et al.,
"Deep Neural Networks as Gaussian Processes", ICLR 2018), in the NTK
parameterization that the SIGMOD 2022 NNGP estimator uses:

    K0 = x1 . x2 / d
    Dense(w_std, b_std):  K <- w^2 K + b^2
    ReLU:                 K <- sqrt(k11 k22) (sin t + (pi - t) cos t) / 2 pi,
                          cos t = K / sqrt(k11 k22);  on the diagonal K / 2

A layer is ["dense", width, w_std, b_std] or ["relu"]; the width does not
enter the kernel. Written from those equations, not from the program.
"""

import math

import torch


def _relu(k, d1, d2):
    kk = torch.clamp_min(d1 * d2, 1e-300 if k.dtype == torch.float64
                         else 1e-36)
    root = torch.sqrt(kk)
    cos_t = torch.clamp(k / root, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return root * (sin_t + (math.pi - torch.acos(cos_t)) * cos_t) \
        / (2.0 * math.pi)


def diag(layers, x):
    """The kernel's diagonal k(x_i, x_i), shape (n,)."""
    k = torch.sum(x * x, dim=1) / x.shape[1]
    for layer in layers:
        if layer[0] == "dense":
            k = layer[2] ** 2 * k + layer[3] ** 2
        elif layer[0] == "relu":
            k = 0.5 * k
        else:
            raise ValueError(f"unknown layer {layer!r}")
    return k


def cross(layers, x1, x2, d1=None, d2=None):
    """The (n1, n2) kernel block k(x1, x2). d1, d2: the input
    diagonals x.x / d of the rows, if already known."""
    d = x1.shape[1]
    if d1 is None:
        d1 = torch.sum(x1 * x1, dim=1) / d
    if d2 is None:
        d2 = torch.sum(x2 * x2, dim=1) / d
    k = (x1 @ x2.mT) / d
    d1, d2 = d1[:, None], d2[None, :]
    for layer in layers:
        if layer[0] == "dense":
            w2, b2 = layer[2] ** 2, layer[3] ** 2
            k, d1, d2 = w2 * k + b2, w2 * d1 + b2, w2 * d2 + b2
        elif layer[0] == "relu":
            k, d1, d2 = _relu(k, d1, d2), 0.5 * d1, 0.5 * d2
        else:
            raise ValueError(f"unknown layer {layer!r}")
    return k


def sym(layers, x, block=4096):
    """k(x, x) with the exact diagonal, built in row blocks."""
    dx = torch.sum(x * x, dim=1) / x.shape[1]
    out = x.new_empty((x.shape[0], x.shape[0]))
    for s in range(0, x.shape[0], block):
        out[s:s + block] = cross(layers, x[s:s + block], x,
                                 dx[s:s + block], dx)
    out.diagonal().copy_(diag(layers, x))
    return out
