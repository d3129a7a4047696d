"""Input-layer Gram: K0 = x1 @ x2.T / d (PyTorch counterpart of
`nngp_tpu/ops/gram.py:20-35`).

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
"""

import torch


def _divisor(x: torch.Tensor) -> torch.Tensor:
    return x.new_full((), float(x.shape[-1]))


def input_gram(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """K0 = x1 @ x2.T / d with shape (n1, n2). d = feature dim."""
    return torch.matmul(x1, x2.mT) / _divisor(x1)


def input_diag(x: torch.Tensor) -> torch.Tensor:
    """diag(x @ x.T) / d = row squared norms / d, shape (n,)."""
    return torch.sum(x * x, dim=-1) / _divisor(x)
