"""Shared helpers for the `nngp_tpu_torch` comparison tests, and tests of
the port's device policy and timer.

Each comparison feeds the same seeded numpy arrays to the JAX package (on
the CPU, fp64 enabled by conftest.py) and to the port on `device="cpu"`,
where every Gram goes through the kernels' plain PyTorch twins. The tier-1
run uses six xdist workers, so torch is held to two threads per process.
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def rows(n, d=20, seed=0, scale=1000.0, dtype=np.float64, special=True):
    """(n, d) rows uniform in [0, scale) from a seeded generator. With
    `special` (d = 20), row 1 is zero and rows 2 and 3 are one duplicated
    pair (rho = 1).

    The duplicated rows are constant 512: their self-product 20 * 512^2 is
    exact in any summation order and K0 = 2^18 comes out exactly under
    both division and multiplication by 1/20. At rho = 1 the NTK and sin
    duals have unbounded slope (sin's dual is exp(k12 - (k11 + k22) / 2)),
    so a one-ulp difference in K0 between two summation orders would show
    there as ~1e-10 in fp64; an exact K0 lets the comparison see the
    duals' own handling of rho = 1 (the clip, acos(1))."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, scale, (n, d))
    if special:
        assert d == 20, "the exact duplicated pair assumes d = 20"
        x[1] = 0.0
        x[2] = x[3] = 512.0
    return x.astype(dtype)


def t(a):
    """numpy -> CPU tensor of the same dtype."""
    return torch.as_tensor(np.asarray(a))


def n(a):
    """JAX array or tensor -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def jax_spec(torch_spec):
    """The JAX KernelSpec with the same layers as a port KernelSpec."""
    from nngp_tpu.models import kernel_spec as jk

    layers = []
    for layer in torch_spec.layers:
        if type(layer).__name__ == "Dense":
            layers.append(jk.Dense(layer.width, layer.w_std, layer.b_std))
        else:
            layers.append(jk.Activation(layer.name))
    return jk.KernelSpec(tuple(layers))


# ---------------------------------------------------------------- device
def test_resolve_device_cpu_and_rejects_other_types():
    from nngp_tpu_torch.utils.device import resolve_device, working_dtype

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert working_dtype(True) == torch.float64
    assert working_dtype(False) == torch.float32


def test_resolve_device_cuda_raises_without_a_gpu():
    from nngp_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda resolves instead of raising")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")


def test_timer_report_format_matches_jax_timer():
    from nngp_tpu.utils.timing import Timer as JaxTimer
    from nngp_tpu_torch.utils.timing import Timer

    lines, jax_lines = [], []
    timer, jax_timer = Timer("cpu"), JaxTimer()
    with timer.measure("fit (warm)"):
        pass
    with jax_timer.measure("fit (warm)"):
        pass
    timer.report(lines.append)
    jax_timer.report(jax_lines.append)
    pattern = r"\[timing\] fit \(warm\): \d+\.\d{4}s"
    assert re.fullmatch(pattern, lines[0])
    assert re.fullmatch(pattern, jax_lines[0])
