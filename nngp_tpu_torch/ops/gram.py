"""Input-layer Gram: K0 = x1 @ x2.T / d, and the train Gram panel by panel
(PyTorch counterpart of `nngp_tpu/ops/gram.py`).

`input_gram` is a plain `torch.matmul` in the working dtype. On CUDA the
device policy (`utils.device.resolve_device`) keeps TF32 off, so float32
products run in full IEEE fp32, the counterpart of JAX's
`Precision.HIGHEST`.

Both functions divide by d exactly, as the CUDA Gram kernels do. A
division by a Python number becomes a multiplication by its rounded
reciprocal on CUDA, one rounding more: at d = 61 that moved K0 of a
duplicated row pair off the power of two it is, so rho = 1 came out one
ulp below 1, where the NTK dual's slope turns the ulp into ~5e-5. A 0-dim
tensor divisor on the same device takes the true division.

`panel_symm_matmul` and `panel_gram` build the symmetric train Gram one
column panel at a time through `ops.gram_cuda.gram_cross` (the CUDA kernel
on the card, its plain twin on the CPU), each panel's diagonal square
given the exact O(n) diagonal, as `gram_sym` gives the whole Gram's.
`panel_symm_matmul` is how a large-n NTK posterior applies K_tt without
keeping it: the only temporary is one (n, block_size) panel.
"""

import torch

# Columns of a panel of `panel_symm_matmul` and `panel_gram`.
SYMM_PANEL = 4096


def _divisor(x: torch.Tensor) -> torch.Tensor:
    return x.new_full((), float(x.shape[-1]))


def input_gram(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """K0 = x1 @ x2.T / d with shape (n1, n2). d = feature dim."""
    return torch.matmul(x1, x2.mT) / _divisor(x1)


def input_diag(x: torch.Tensor) -> torch.Tensor:
    """diag(x @ x.T) / d = row squared norms / d, shape (n,)."""
    return torch.sum(x * x, dim=-1) / _divisor(x)


def _panels(spec, x, get, block_size):
    """(s, e, K[:, s:e]) of the (n, n) Gram of kernel `get`, panel by panel:
    `gram_cross(spec, x, x[s:e], get)` with the diagonal square's diagonal
    set to the exact one (`diag_eval`)."""
    from nngp_tpu_torch.models.kernel_spec import diag_eval
    from nngp_tpu_torch.ops.gram_cuda import gram_cross

    n = x.shape[0]
    exact = diag_eval(spec.layers, x, get)
    for s in range(0, n, int(block_size)):
        e = min(s + int(block_size), n)
        panel = gram_cross(spec, x, x[s:e], get)
        panel[s:e].diagonal().copy_(exact[s:e])
        yield s, e, panel


def panel_symm_matmul(spec, x: torch.Tensor, w: torch.Tensor, get="nngp",
                      block_size: int = SYMM_PANEL) -> torch.Tensor:
    """K @ w for the symmetric (n, n) Gram K of kernel `get` over the rows x,
    without materializing K: panel k adds K[:, s:e] @ w[s:e] to one (n, m)
    accumulator. A w of a wider dtype than x's (fp64 against an fp32
    posterior) gets its product in its own dtype."""
    out = w.new_zeros((x.shape[0], w.shape[1]))
    for s, e, panel in _panels(spec, x, get, block_size):
        out.addmm_(panel if panel.dtype == w.dtype else panel.to(w.dtype),
                   w[s:e])
    return out


def panel_gram(spec, x: torch.Tensor, get="nngp",
               block_size: int = SYMM_PANEL) -> torch.Tensor:
    """The symmetric (n, n) Gram of kernel `get` written panel by panel into
    one output: the only other temporary is one (n, block_size) panel."""
    out = x.new_empty((x.shape[0], x.shape[0]))
    for s, e, panel in _panels(spec, x, get, block_size):
        out[:, s:e] = panel
    return out
