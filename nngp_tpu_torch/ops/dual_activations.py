"""Closed-form dual activations for infinite-width network kernels.

PyTorch counterpart of `nngp_tpu/ops/dual_activations.py` (`DUALS` and
`DUALS_NTK_DIAG`, :44-167). Each nonlinearity maps the pre-activation
covariance through a dual T (NNGP) and its derivative dual Tdot (NTK
multiplier):

  ReLU  (arccos kernel):  T = sqrt(k11 k22) (sin t + (pi - t) cos t) / (2 pi)
                          Tdot = (pi - t) / (2 pi),  cos t = k12 / sqrt(k11 k22)
  Erf   (arcsin kernel):  T = (2/pi) asin(2 k12 / sqrt((1 + 2 k11)(1 + 2 k22)))
                          Tdot = (4/pi) / sqrt((1 + 2 k11)(1 + 2 k22) - 4 k12^2)

The JAX package builds acos/asin by hand because Mosaic lacks them
(`nngp_tpu/ops/math.py:1-16`); here they are `torch.acos`/`torch.asin`.
The numerical guards are kept exactly: the 1e-36 floor that keeps zero-norm
rows finite, the clip of the cosine to [-1, 1], the 1e-30 floor in
`erf_ntk_mult`, and the exact on-diagonal maps. The CUDA Gram kernel
(`csrc/gram.cu`) evaluates the same expressions in the same order.

All functions are elementwise on broadcastable tensors of one dtype.
"""

import torch

_INV_2PI = 0.15915494309189535  # 1 / (2 pi)
_PI = 3.141592653589793


def _relu_cos(k12, k11, k22):
    """(cos t, sqrt(k11 k22)) with the zero-row floor: rsqrt(0) = inf would
    turn 0 * inf into NaN; the floored path returns ~1e-18 for the true 0
    (1e-36 stays in fp32's normal range)."""
    kk = torch.clamp_min(k11 * k22, 1e-36)
    inv = torch.rsqrt(kk)
    return torch.clamp(k12 * inv, -1.0, 1.0), kk * inv


def relu_nngp(k12, k11, k22):
    """E[relu(u) relu(v)] for (u, v) ~ N(0, [[k11, k12], [k12, k22]])."""
    cos_t, sqrt_kk = _relu_cos(k12, k11, k22)
    theta = torch.acos(cos_t)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return sqrt_kk * (sin_t + (_PI - theta) * cos_t) * _INV_2PI


def relu_ntk_mult(k12, k11, k22):
    """E[relu'(u) relu'(v)] = (pi - theta) / (2 pi)."""
    cos_t, _ = _relu_cos(k12, k11, k22)
    return (_PI - torch.acos(cos_t)) * _INV_2PI


def relu_diag(k):
    """T(k; k, k) = k / 2 exactly."""
    return 0.5 * k


def relu_ntk_mult_diag(k):
    """Tdot(k; k, k) = 1/2 exactly: the generic form evaluates acos at
    rho = 1 +- rounding, where its sqrt(eps) slope injects noise."""
    return torch.full_like(k, 0.5)


def erf_nngp(k12, k11, k22):
    """(2/pi) asin(2 k12 / sqrt((1 + 2 k11)(1 + 2 k22)))."""
    inv = torch.rsqrt((1.0 + 2.0 * k11) * (1.0 + 2.0 * k22))
    ratio = torch.clamp(2.0 * k12 * inv, -1.0, 1.0)
    return (2.0 / _PI) * torch.asin(ratio)


def erf_ntk_mult(k12, k11, k22):
    """(4/pi) / sqrt((1 + 2 k11)(1 + 2 k22) - 4 k12^2)."""
    denom_sq = (1.0 + 2.0 * k11) * (1.0 + 2.0 * k22) - 4.0 * k12 * k12
    return (4.0 / _PI) * torch.rsqrt(torch.clamp_min(denom_sq, 1e-30))


def erf_diag(k):
    """(2/pi) asin(2k / (1 + 2k))."""
    return (2.0 / _PI) * torch.asin(2.0 * k / (1.0 + 2.0 * k))


def erf_ntk_mult_diag(k):
    """(4/pi) / sqrt(1 + 4k): the generic form minus its cancellation."""
    return (4.0 / _PI) * torch.rsqrt(1.0 + 4.0 * k)


def sin_nngp(k12, k11, k22):
    """E[sin u sin v] = e^{-(k11 + k22)/2} sinh(k12), as a difference of
    exps with non-positive arguments (never overflows)."""
    a = -0.5 * (k11 + k22)
    return 0.5 * (torch.exp(a + k12) - torch.exp(a - k12))


def sin_ntk_mult(k12, k11, k22):
    """E[cos u cos v] = e^{-(k11 + k22)/2} cosh(k12)."""
    a = -0.5 * (k11 + k22)
    return 0.5 * (torch.exp(a + k12) + torch.exp(a - k12))


def sin_diag(k):
    """T(k; k, k) = (1 - e^{-2k}) / 2."""
    return 0.5 * (1.0 - torch.exp(-2.0 * k))


def sin_ntk_mult_diag(k):
    """Tdot(k; k, k) = (1 + e^{-2k}) / 2."""
    return 0.5 * (1.0 + torch.exp(-2.0 * k))


def abs_nngp(k12, k11, k22):
    """|x| = relu(x) + relu(-x): 2 T_relu(k12) + 2 T_relu(-k12)."""
    return 2.0 * (relu_nngp(k12, k11, k22) + relu_nngp(-k12, k11, k22))


def abs_ntk_mult(k12, k11, k22):
    """E[sign(u) sign(v)] = 2 Tdot_relu(k12) - 2 Tdot_relu(-k12)."""
    return 2.0 * (relu_ntk_mult(k12, k11, k22)
                  - relu_ntk_mult(-k12, k11, k22))


def abs_diag(k):
    """T(k; k, k) = E[|u|^2] = k exactly."""
    return k


def abs_ntk_mult_diag(k):
    """Tdot(k; k, k) = E[sign(u)^2] = 1 exactly."""
    return torch.ones_like(k)


# name -> (T, Tdot, T on the diagonal)
DUALS = {
    "relu": (relu_nngp, relu_ntk_mult, relu_diag),
    "erf": (erf_nngp, erf_ntk_mult, erf_diag),
    "sin": (sin_nngp, sin_ntk_mult, sin_diag),
    "abs": (abs_nngp, abs_ntk_mult, abs_diag),
}

# Exact on-diagonal NTK multipliers (apply_diag_recursion).
DUALS_NTK_DIAG = {
    "relu": relu_ntk_mult_diag,
    "erf": erf_ntk_mult_diag,
    "sin": sin_ntk_mult_diag,
    "abs": abs_ntk_mult_diag,
}
