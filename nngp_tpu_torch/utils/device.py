"""Device and dtype policy.

Every entry point takes an explicit device; there is no global default and
no fallback. Asking for CUDA on a machine without it raises.

On CUDA, float32 matmuls must run in full IEEE fp32: features lie in
[0, 1000], Gram entries are ~1e5, and the relative ridge is 1e-3 of the
diagonal. TF32 (about three decimal digits) is the same class of error as
the one-pass bf16 that NaNed the forest Cholesky in the JAX package
(`nngp_tpu/ops/gram_pallas.py:73-75`), so both TF32 switches are turned off
and the matmul precision is checked to be "highest".
"""

import torch


def resolve_device(name) -> torch.device:
    """torch.device for `name` ("cpu", "cuda", "cuda:1", ...), with the
    CUDA precision policy applied. Raises if CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        precision = torch.get_float32_matmul_precision()
        if precision != "highest":
            raise RuntimeError(
                "float32 matmul precision must be 'highest' (TF32 off), got "
                f"{precision!r}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; use cpu or cuda")
    return dev


def working_dtype(x64: bool) -> torch.dtype:
    """fp64 for oracle-grade runs, fp32 otherwise (the card's working type)."""
    return torch.float64 if x64 else torch.float32
