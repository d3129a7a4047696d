"""Input-layer Gram: K0 = x1 @ x2.T / d (PyTorch counterpart of
`nngp_tpu/ops/gram.py:20-35`).

`input_gram` is a plain `torch.matmul` in the working dtype. On CUDA the
device policy (`utils.device.resolve_device`) keeps TF32 off, so float32
products run in full IEEE fp32, the counterpart of JAX's
`Precision.HIGHEST`.
"""

import torch


def input_gram(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """K0 = x1 @ x2.T / d with shape (n1, n2). d = feature dim."""
    return torch.matmul(x1, x2.mT) / x1.shape[-1]


def input_diag(x: torch.Tensor) -> torch.Tensor:
    """diag(x @ x.T) / d = row squared norms / d, shape (n,)."""
    return torch.sum(x * x, dim=-1) / x.shape[-1]
