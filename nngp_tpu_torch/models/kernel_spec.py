"""Infinite-width network kernel specs (PyTorch counterpart of
`nngp_tpu/models/kernel_spec.py`).

The architecture is a tuple of layer dataclasses; the kernel is the
closed-form recursion over (cross covariance, diagonal covariances):

    K0   = x1 @ x2.T / d            (NTK parameterization)
    Dense(w_std, b_std):  nngp' = w^2 nngp + b^2 ;  ntk' = w^2 ntk + nngp'
    Nonlinearity phi:     ntk'  = ntk * Tdot(nngp) ;  nngp' = T(nngp)

Layer widths never enter the kernel. The recursion is elementwise given K0;
`ops/gram_cuda.py` runs the same recursion inside the CUDA Gram kernels.
"""

import dataclasses
from typing import Sequence, Tuple

import torch

from nngp_tpu_torch.ops.dual_activations import DUALS, DUALS_NTK_DIAG
from nngp_tpu_torch.ops.gram import input_diag, input_gram


@dataclasses.dataclass(frozen=True)
class Dense:
    width: int = 512
    w_std: float = 1.0
    b_std: float = 0.0  # no bias == 0


@dataclasses.dataclass(frozen=True)
class Activation:
    name: str

    def __post_init__(self):
        if self.name not in DUALS:
            raise ValueError(f"Unknown activation {self.name!r}; have {list(DUALS)}")


def Relu() -> Activation:
    return Activation("relu")


def Erf() -> Activation:
    return Activation("erf")


Layer = object  # Dense | Activation


def mlp(depth: int = 1, width: int = 512, activation: str = "relu",
        w_std: float = 1.0, b_std: float = 0.0) -> Tuple[Layer, ...]:
    """`depth` hidden layers: Dense,Act,...,Dense(1). depth=1 is the
    paper's architecture."""
    layers = []
    for _ in range(depth):
        layers += [Dense(width, w_std, b_std), Activation(activation)]
    layers.append(Dense(1, w_std, b_std))
    return tuple(layers)


def _validate(layers: Sequence[Layer]):
    if not layers or not isinstance(layers[0], Dense):
        raise ValueError("Kernel spec must start with a Dense layer")
    for l in layers:
        if not isinstance(l, (Dense, Activation)):
            raise TypeError(f"Unknown layer {l!r}")


def apply_recursion(k, ntk, d1, d2, layers: Sequence[Layer], duals=None):
    """Run the dual recursion on a cross block.

    k:   (m, n) input covariance block  x1 @ x2.T / d
    ntk: (m, n) running NTK (zeros at input)
    d1:  (m, 1) input diag covariances of x1 rows
    d2:  (1, n) input diag covariances of x2 rows

    `duals` selects the activation-dual registry (default DUALS; the
    hyperparameter loss passes its grad-safe one). Returns (nngp, ntk) for
    the block."""
    if duals is None:
        duals = DUALS
    for layer in layers:
        if isinstance(layer, Dense):
            w2 = layer.w_std ** 2
            b2 = layer.b_std ** 2
            k = w2 * k + b2
            ntk = w2 * ntk + k
            d1 = w2 * d1 + b2
            d2 = w2 * d2 + b2
        else:
            t, tdot, tdiag = duals[layer.name]
            ntk = ntk * tdot(k, d1, d2)
            k = t(k, d1, d2)
            d1 = tdiag(d1)
            d2 = tdiag(d2)
    return k, ntk


# Duals positively 1-homogeneous in the input covariance: with a bias-free
# stack, scaling every input by s scales both Grams by exactly s^2.
_HOMOGENEOUS_ACTS = frozenset({"relu", "abs"})


def is_scale_equivariant(layers: Sequence[Layer]) -> bool:
    """True iff kernel(s*x1, s*x2) == s^2 * kernel(x1, x2) for both gets:
    every Dense bias-free and every activation dual 1-homogeneous."""
    for layer in layers:
        if isinstance(layer, Dense):
            if layer.b_std != 0.0:
                return False
        elif isinstance(layer, Activation):
            if layer.name not in _HOMOGENEOUS_ACTS:
                return False
    return True


def apply_diag_recursion(d, layers: Sequence[Layer]):
    """Propagate only diagonal covariances, with the exact on-diagonal
    duals (the generic Tdot(k; k, k) evaluates acos at rho = 1 +-
    rounding). Returns (nngp, ntk) diagonals."""
    nngp = d
    ntk = torch.zeros_like(d)
    for layer in layers:
        if isinstance(layer, Dense):
            nngp = layer.w_std ** 2 * nngp + layer.b_std ** 2
            ntk = layer.w_std ** 2 * ntk + nngp
        else:
            _, _, tdiag = DUALS[layer.name]
            ntk = ntk * DUALS_NTK_DIAG[layer.name](nngp)
            nngp = tdiag(nngp)
    return nngp, ntk


def kernel_eval(layers, x1, x2=None, get="nngp"):
    """`KernelSpec.kernel_fn` as a free function over a layer tuple."""
    if x2 is None:
        x2 = x1
    k0 = input_gram(x1, x2)
    d1 = input_diag(x1)[:, None]
    d2 = input_diag(x2)[None, :]
    nngp, ntk = apply_recursion(k0, torch.zeros_like(k0), d1, d2, layers)
    return KernelSpec._select(nngp, ntk, get)


def diag_eval(layers, x, get="nngp"):
    """`KernelSpec.diag_fn` as a free function."""
    nngp, ntk = apply_diag_recursion(input_diag(x), layers)
    return KernelSpec._select(nngp, ntk, get)


def self_kernel_eval(layers, x, get="nngp"):
    """kernel_eval(x, x) with the exact on-diagonal recursion written onto
    the diagonal (the generic dual carries acos(rho=1) noise there)."""
    out = kernel_eval(layers, x, x, get)
    diag = diag_eval(layers, x, get)
    if isinstance(out, tuple):
        for k, dk in zip(out, diag):
            k.diagonal().copy_(dk)
    else:
        out.diagonal().copy_(diag)
    return out


class KernelSpec:
    """kernel_fn over a serial layer stack. get in {'nngp','ntk'} or a tuple.

    Hash/eq are structural (by layer tuple)."""

    def __init__(self, layers: Sequence[Layer]):
        _validate(layers)
        self.layers = tuple(layers)

    def __hash__(self):
        return hash(self.layers)

    def __eq__(self, other):
        return isinstance(other, KernelSpec) and self.layers == other.layers

    def __repr__(self):
        return f"KernelSpec({self.layers!r})"

    def __call__(self, x1, x2=None, get="nngp"):
        return self.kernel_fn(x1, x2, get)

    def kernel_fn(self, x1, x2=None, get="nngp"):
        """Dense Gram matrix of shape (n1, n2) for the requested kernel(s)."""
        return kernel_eval(self.layers, x1, x2, get)

    def diag_fn(self, x, get="nngp"):
        """Diagonal entries kernel(x_i, x_i), shape (n,)."""
        return diag_eval(self.layers, x, get)

    def self_kernel(self, x, get="nngp"):
        """kernel_fn(x, x) with the diagonal overwritten by the exact
        on-diagonal recursion."""
        return self_kernel_eval(self.layers, x, get)

    @staticmethod
    def _select(nngp, ntk, get):
        if isinstance(get, (tuple, list)):
            out = {"nngp": nngp, "ntk": ntk}
            return tuple(out[g] for g in get)
        if get == "nngp":
            return nngp
        if get == "ntk":
            return ntk
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")


def reference_kernel(width: int = 512) -> KernelSpec:
    """The paper's architecture: Dense(width) -> Relu -> Dense(1)."""
    return KernelSpec((Dense(width), Relu(), Dense(1)))
