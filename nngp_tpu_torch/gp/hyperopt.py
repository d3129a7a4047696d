"""Kernel hyperparameter learning by exact marginal likelihood (PyTorch
counterpart of `nngp_tpu/gp/hyperopt.py`).

For an `mlp(depth, activation)` kernel it learns

    w0    first-Dense weight std (a learned input scale: K0 = x x^T / d
          enters the stack only through w0^2 K0 + b^2)
    w     weight std of the later Dense layers
    b     bias std of every Dense layer
    reg   relative ridge (noise-to-signal ratio)

or, with ard=True, a per-feature input scale s in place of w0, by
maximizing the GP log evidence of a seeded subsample of the training rows
with Adam. The objective is the exact GP's evidence, or ('dtc') that of the
DTC/Nystrom model the streaming tier serves.

The losses are plain differentiable torch ops and their gradients come from
torch.autograd. The CUDA Gram kernels have no backward, and the JAX package
computes these losses with plain XLA ops too (`input_gram` and
`apply_recursion`, never its Pallas kernel).

The R restarts (one per initial ridge: the evidence is multimodal in the
ridge) ride on a leading batch dimension of every parameter: w0, w, b and
the ridge are (R,) tensors, the ARD scale is (R, d), and a step is one
batched forward and backward. Adam is written out with optax's defaults and
guarded as `optax.apply_if_finite(adam, max_consecutive_errors=8)` guards
it, per restart: a step whose gradient is not finite leaves that restart's
parameters, moments and step count unchanged, and after more than 8
consecutive rejections the update is applied anyway.

Differentiability: the ReLU/erf duals evaluate arccos/arcsin at rho = +-1
on the Gram diagonal and at duplicate rows, where their slope is infinite.
The grad-safe duals clamp rho into (-1 + eps, 1 - eps), and the diagonal is
then replaced by the exact, smooth `apply_diag_recursion`, so the clamp
never biases the trace. Where `jnp.linalg.cholesky` returns NaN for a
matrix that is not positive definite, `torch.linalg.cholesky` raises: the
losses factor with `cholesky_ex`, whose per-batch `info` turns that
restart's loss into NaN, and a restart with a NaN loss counts as a
non-finite step (a failed factor's backward can return finite garbage).

With all hyperparameters pinned at the reference defaults the exact loss
equals `GPPosterior.log_marginal_likelihood` (tests).
"""

import dataclasses
import json
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nngp_tpu_torch.models.kernel_spec import (Activation, Dense, KernelSpec,
                                               apply_diag_recursion,
                                               apply_recursion)
from nngp_tpu_torch.ops.dual_activations import (erf_diag, sin_diag, sin_nngp,
                                                 sin_ntk_mult)
from nngp_tpu_torch.parallel.mesh import (all_reduce_sum,
                                          all_reduce_sum_many)
from nngp_tpu_torch.gp.posterior import _as_tensor
from nngp_tpu_torch.ops.gram import input_diag, input_gram
from nngp_tpu_torch.utils.device import resolve_device

_PI = 3.141592653589793
_INV_2PI = 0.15915494309189535
_LOG_2PI = math.log(2.0 * math.pi)

# optax.adam's defaults and optax.apply_if_finite's tolerance
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_MAX_CONSECUTIVE_ERRORS = 8


def _grad_safe_duals(eps):
    """Dual-activation registry with rho clamped strictly inside (-1, 1):
    `ops.dual_activations.DUALS` up to O(eps^1.5) forward error, with
    finite gradients everywhere (acos'(rho) ~ 1/sqrt(1 - rho^2))."""
    hi = 1.0 - eps

    def relu_nngp_s(k12, k11, k22):
        kk = torch.clamp_min(k11 * k22, 1e-36)
        inv = torch.rsqrt(kk)
        cos_t = torch.clamp(k12 * inv, -hi, hi)
        theta = torch.acos(cos_t)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, eps * eps))
        return (kk * inv) * (sin_t + (_PI - theta) * cos_t) * _INV_2PI

    def relu_ntk_mult_s(k12, k11, k22):
        cos_t = torch.clamp(
            k12 * torch.rsqrt(torch.clamp_min(k11 * k22, 1e-36)), -hi, hi)
        return (_PI - torch.acos(cos_t)) * _INV_2PI

    def relu_diag(k):
        return 0.5 * k

    def erf_nngp_s(k12, k11, k22):
        inv = torch.rsqrt((1.0 + 2.0 * k11) * (1.0 + 2.0 * k22))
        ratio = torch.clamp(2.0 * k12 * inv, -hi, hi)
        return (2.0 / _PI) * torch.asin(ratio)

    def erf_ntk_mult_s(k12, k11, k22):
        denom_sq = (1.0 + 2.0 * k11) * (1.0 + 2.0 * k22) - 4.0 * k12 * k12
        return (4.0 / _PI) * torch.rsqrt(torch.clamp_min(denom_sq, eps))

    def abs_nngp_s(k12, k11, k22):
        return 2.0 * (relu_nngp_s(k12, k11, k22)
                      + relu_nngp_s(-k12, k11, k22))

    def abs_ntk_mult_s(k12, k11, k22):
        return 2.0 * (relu_ntk_mult_s(k12, k11, k22)
                      - relu_ntk_mult_s(-k12, k11, k22))

    return {
        "relu": (relu_nngp_s, relu_ntk_mult_s, relu_diag),
        "erf": (erf_nngp_s, erf_ntk_mult_s, erf_diag),
        "sin": (sin_nngp, sin_ntk_mult, sin_diag),   # smooth everywhere
        "abs": (abs_nngp_s, abs_ntk_mult_s, lambda k: k),
    }


def _build_layers(depth, activation, width, w0, w, b):
    """The `mlp` stack with the first Dense carrying w0 (the learned input
    scale), later Dense layers sharing w, and every Dense sharing b. The
    stds may be tensors: (R, 1, 1) per restart inside the losses."""
    layers = [Dense(width, w0, b), Activation(activation)]
    for _ in range(depth - 1):
        layers += [Dense(width, w, b), Activation(activation)]
    layers.append(Dense(1, w, b))
    return tuple(layers)


def _per_restart(v):
    """(R,) hyperparameter -> (R, 1, 1), broadcasting over an (n, n) block."""
    return v[:, None, None]


def _c_moments(psi, ym):
    """The DTC loss's C = psi psi^T and b = psi ym, in fp64 whatever psi's
    dtype. C is positive semidefinite to fp64 rounding at any GEMM order,
    so C + rI keeps a smallest eigenvalue near r. In fp32 the margin was
    below eps_fp32 * lambda_max: at reg_rel 1e-3 on 90,000 rows
    kappa(C + rI) ~ n / reg_rel > 1 / eps_fp32, and which cuBLAS kernel
    formed C decided whether C + rI stayed positive definite
    (experiments/torch_dtc_learn_nan.py). The JAX package forms C in fp32
    at HIGHEST precision."""
    p = psi.to(torch.float64)
    return p @ p.mT, p @ ym.to(torch.float64)


def _c_factor(c, r):
    """cholesky_ex of C + r I, r per restart: (factor, info)."""
    eye = torch.eye(c.shape[-1], dtype=c.dtype, device=c.device)
    return torch.linalg.cholesky_ex(c + _per_restart(r) * eye)


def _diag_kernel(d, layers, get):
    """Exact (R, n) diagonal of the solve kernel from the ([R,] n) input
    diagonal d (the recursion broadcasts it to (R, 1, n))."""
    dn, dt = apply_diag_recursion(d[..., None, :], layers)
    return (dt if get == "ntk" else dn)[..., 0, :]


def _nll_from_moments(k0, d1, y, layers, get, duals, reg_rel):
    """Exact negative log evidence of N(0, K + reg * mean(diag K) I), one
    per restart, given the input moments k0 ([R,] n, n) and d1 ([R,] n),
    y (n, 1), a layer stack with (R, 1, 1) stds and reg_rel (R,). A failed
    factor gives NaN. Returns (R,)."""
    n = k0.shape[-1]
    nngp, ntk = apply_recursion(k0, torch.zeros_like(k0), d1[..., :, None],
                                d1[..., None, :], layers, duals=duals)
    k = ntk if get == "ntk" else nngp
    dvec = _diag_kernel(d1, layers, get)
    # the exact smooth diagonal: removes the acos-at-rho=1 singularity and
    # the clamp bias in one move (out of place: autograd needs k)
    k = torch.diagonal_scatter(k, dvec, dim1=-2, dim2=-1)
    reg = reg_rel * torch.mean(dvec, dim=-1)
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    ell, info = torch.linalg.cholesky_ex(k + _per_restart(reg) * eye)
    alpha = torch.cholesky_solve(y.expand(k.shape[0], n, y.shape[-1]), ell)
    quad = torch.sum(y * alpha, dim=(-2, -1))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(ell, dim1=-2,
                                                      dim2=-1)), dim=-1)
    nll = 0.5 * (quad + logdet + n * _LOG_2PI)
    return torch.where(info > 0, torch.nan, nll)


def _nll(theta, k0, d1, y, depth, activation, width, get, duals):
    """Scalar-hyperparameter loss. Takes the theta-independent input
    moments (k0 = x x^T / d, d1 its diagonal), so the n^2 d input matmul is
    paid once per optimization, not per step."""
    w0, w, b, reg_rel = (torch.exp(theta[k]) for k in
                         ("log_w0", "log_w", "log_b", "log_reg"))
    layers = _build_layers(depth, activation, width, _per_restart(w0),
                           _per_restart(w), _per_restart(b))
    return _nll_from_moments(k0, d1, y, layers, get, duals, reg_rel)


def _nll_ard(theta, x, y, depth, activation, width, get, duals):
    """ARD loss: the first Dense sees x * s (s per feature and restart,
    subsuming w0), so the input Gram is s-dependent and runs every step."""
    s = torch.exp(theta["log_s"])
    w, b, reg_rel = (torch.exp(theta[k]) for k in
                     ("log_w", "log_b", "log_reg"))
    xs = x * s[:, None, :]
    layers = _build_layers(depth, activation, width, 1.0, _per_restart(w),
                           _per_restart(b))
    return _nll_from_moments(input_gram(xs, xs), input_diag(xs), y, layers,
                             get, duals, reg_rel)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) of a rank's row moments; the backward is the
    identity, so each rank backpropagates only its own rows' share and the
    parameter gradients are summed over ranks afterwards.
    `torch.distributed.nn.functional.all_reduce` is no substitute: its
    backward all-reduces the incoming gradient, and a loss replicated on
    every rank would get p times its gradient."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _nll_dtc(theta, x, y, m, depth, activation, width, get, duals,
             mask=None, mm_jitter_rel=None, x_m=None, group=None):
    """Exact negative log evidence of the DTC/Nystrom model: y ~ N(0,
    Q + r I) with Q = K_nm K_mm^-1 K_mn over the FIRST m rows as inducing
    points (`fit_kernel_hyperparams` permutes the rows once so the prefix
    is a uniform draw). Scalar or ARD by the keys of theta. Cost per step
    O(n m^2 + m^3). K_mm's diagonal is the exact recursion; both factors
    are jittered relative to the model's own scales, and a failed one
    gives NaN. The m x m stage after psi (C, b, the factor of C + rI, t
    and the evidence) runs in fp64 (`_c_moments`), and the loss returns
    in x's dtype. Returns (R,).

    mask: (n,) 0/1 row weights; a row with mask 0 contributes nothing (its
    kernel row, its y, its share of the ridge's trace and of the n in the
    evidence). Every term but the m x m stage is then a sum over rows, so
    the loss shards by rows: with `group` (the mesh path), x, y and mask
    are this rank's rows, x_m the inducing rows (on every rank), and the
    row sums go through one all-reduce before the m x m stage."""
    if x_m is None:
        x_m = x[..., :m, :]
    if "log_s" in theta:
        s = torch.exp(theta["log_s"])[:, None, :]
        x, x_m = x * s, x_m * s
        w0 = 1.0
    else:
        w0 = _per_restart(torch.exp(theta["log_w0"]))
    w, b, reg_rel = (torch.exp(theta[k]) for k in
                     ("log_w", "log_b", "log_reg"))
    layers = _build_layers(depth, activation, width, w0, _per_restart(w),
                           _per_restart(b))
    d_all, d_m = input_diag(x), input_diag(x_m)
    dvec, dvec_m = (_diag_kernel(v, layers, get) for v in (d_all, d_m))
    if mask is None:
        n_eff, ym, tr = x.shape[-2], y, torch.sum(dvec, dim=-1)
    else:
        n_eff, ym = torch.sum(mask), y * mask[:, None]
        tr = torch.sum(dvec * mask, dim=-1)

    k0_mm = input_gram(x_m, x_m)
    nngp_mm, ntk_mm = apply_recursion(k0_mm, torch.zeros_like(k0_mm),
                                      d_m[..., :, None], d_m[..., None, :],
                                      layers, duals=duals)
    k_mm = ntk_mm if get == "ntk" else nngp_mm
    k_mm = torch.diagonal_scatter(k_mm, dvec_m, dim1=-2, dim2=-1)
    # fp32 needs a far larger relative jitter than fp64: near-duplicate
    # rows make kappa(K_mm) exceed 1/eps_fp32 (the JAX package measured
    # 1e-6 -> NaN factor, 1e-4 stable on synth6_big chunk_norm); the shift
    # is shared by every candidate theta, so the argmax is kept
    if mm_jitter_rel is None:
        mm_jitter_rel = 1e-10 if x.dtype == torch.float64 else 1e-4
    eye = torch.eye(m, dtype=k_mm.dtype, device=k_mm.device)
    jitter = mm_jitter_rel * torch.mean(dvec_m, dim=-1)
    l_mm, info_mm = torch.linalg.cholesky_ex(k_mm + _per_restart(jitter)
                                             * eye)

    k0_nm = input_gram(x, x_m)
    nngp_nm, ntk_nm = apply_recursion(k0_nm, torch.zeros_like(k0_nm),
                                      d_all[..., :, None],
                                      d_m[..., None, :], layers, duals=duals)
    k_nm = ntk_nm if get == "ntk" else nngp_nm
    if mask is not None:
        # a masked row's kernel values are nonzero whenever b > 0 (the bias
        # enters every layer): mask after the recursion
        k_nm = k_nm * mask[:, None]
    psi = torch.linalg.solve_triangular(l_mm, k_nm.mT, upper=False)
    c, b_m = _c_moments(psi, ym)
    f64 = c.dtype
    rtr = (reg_rel * tr).to(f64)
    ym64 = ym.to(f64)
    yy = torch.sum(ym64 * ym64)
    n_eff = torch.as_tensor(n_eff, dtype=f64, device=c.device)
    if group is not None:
        rr = c.shape[0]
        packed = _SumOverRanks.apply(
            torch.cat([c.reshape(rr, -1), b_m.reshape(rr, -1),
                       rtr[:, None]], dim=1), group)
        c = packed[:, :m * m].reshape(rr, m, m)
        b_m = packed[:, m * m:m * m + m].reshape(rr, m, 1)
        rtr = packed[:, -1]
        n_eff, yy = all_reduce_sum(torch.stack([n_eff, yy]).detach(), group)
    r = rtr / n_eff
    l_c, info_c = _c_factor(c, r)
    t = torch.linalg.solve_triangular(l_c, b_m, upper=False)
    quad = (yy - torch.sum(t * t, dim=(-2, -1))) / r
    logdet = ((n_eff - m) * torch.log(r)
              + 2.0 * torch.sum(torch.log(torch.diagonal(
                  l_c, dim1=-2, dim2=-1)), dim=-1))
    nll = (0.5 * (quad + logdet + n_eff * _LOG_2PI)).to(x.dtype)
    return torch.where((info_mm > 0) | (info_c > 0), torch.nan, nll)


class _GuardedAdam:
    """`optax.apply_if_finite(optax.adam(lr), max_consecutive_errors=8)`
    for R independent restarts: every leaf of theta has the restart on its
    leading dimension, and each restart keeps its own moments, count of
    accepted steps and count of consecutive rejections. Adam has optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""

    def __init__(self, theta, lr):
        self.lr = lr
        self.mu = {k: torch.zeros_like(v) for k, v in theta.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in theta.items()}
        first = next(iter(theta.values()))
        self.restarts = first.shape[0]
        self.count = torch.zeros(self.restarts, dtype=torch.int64,
                                 device=first.device)
        self.notfinite = torch.zeros_like(self.count)

    @torch.no_grad()
    def step(self, theta, grads, ok):
        """The next theta. ok: (R,) False where the restart's step is
        rejected whatever its gradient (a NaN loss); a restart whose
        gradient has a non-finite entry in any leaf is rejected too. A
        rejected restart keeps its parameters and state, unless this is
        its ninth consecutive rejection or later."""
        r = self.restarts
        for g in grads.values():
            ok = ok & torch.isfinite(g).reshape(r, -1).all(dim=1)
        self.notfinite = torch.where(ok, 0, self.notfinite + 1)
        apply = ok | (self.notfinite > _MAX_CONSECUTIVE_ERRORS)
        count_inc = self.count + 1
        # optax's bias correction, from the count of accepted steps
        bc1 = 1.0 - _B1 ** count_inc.double()
        bc2 = 1.0 - _B2 ** count_inc.double()
        out = {}
        for k, g in grads.items():
            shape = (r,) + (1,) * (g.dim() - 1)
            take = apply.reshape(shape)
            mu = (1.0 - _B1) * g + _B1 * self.mu[k]
            nu = (1.0 - _B2) * (g * g) + _B2 * self.nu[k]
            upd = (mu / bc1.to(g.dtype).reshape(shape)) / (
                torch.sqrt(nu / bc2.to(g.dtype).reshape(shape)) + _ADAM_EPS)
            out[k] = torch.where(take, theta[k] + (-self.lr) * upd,
                                 theta[k])
            self.mu[k] = torch.where(take, mu, self.mu[k])
            self.nu[k] = torch.where(take, nu, self.nu[k])
        self.count = torch.where(apply, count_inc, self.count)
        return out


def _optimize(x, y, theta0s, depth, activation, width, get, steps, lr, eps,
              ard=False, objective="exact", dtc_m=0, mm_jitter_rel=None,
              mask=None, x_m=None, group=None):
    """`steps` guarded Adam iterations of the loss for every restart at
    once (leading dimension R of every entry of theta0s). Returns the
    restart with the lowest finite final loss: (its theta, its per-step
    loss history (steps,), its final loss). With `group` (the mesh path of
    the DTC loss) x, y and mask are this rank's rows; the loss is the same
    on every rank, the gradients are summed over ranks, and every rank
    takes the same step."""
    duals = _grad_safe_duals(eps)
    if objective == "dtc":
        def loss(th):
            return _nll_dtc(th, x, y, dtc_m, depth, activation, width, get,
                            duals, mask, mm_jitter_rel, x_m, group)
    elif ard:
        def loss(th):
            return _nll_ard(th, x, y, depth, activation, width, get, duals)
    else:
        k0 = input_gram(x, x)
        d1 = input_diag(x)

        def loss(th):
            return _nll(th, k0, d1, y, depth, activation, width, get, duals)

    theta = {k: v.detach().clone() for k, v in theta0s.items()}
    opt = _GuardedAdam(theta, lr)
    hist = []
    for _ in range(steps):
        theta = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
        val = loss(theta)
        grads = dict(zip(theta, torch.autograd.grad(val.sum(),
                                                    list(theta.values()))))
        if group is not None:     # each rank's share, summed
            grads = dict(zip(grads, all_reduce_sum_many(
                list(grads.values()), group)))
        hist.append(val.detach())
        # a failed factor's NaN loss rejects the step: its backward can
        # still return finite garbage
        theta = opt.step({k: v.detach() for k, v in theta.items()}, grads,
                         torch.isfinite(val.detach()))
    with torch.no_grad():
        final = loss(theta)
        best = int(torch.argmin(torch.where(torch.isfinite(final), final,
                                            torch.inf)))
    hist = (torch.stack(hist) if hist else
            final.new_zeros((0, final.shape[0])))
    return ({k: v[best] for k, v in theta.items()}, hist[:, best],
            final[best])


@dataclasses.dataclass(frozen=True)
class HyperoptResult:
    """Learned kernel hyperparameters and the spec/ridge to fit with."""

    spec: KernelSpec                 # mlp stack with the learned (w0, w, b)
    diag_reg: float                  # learned RELATIVE ridge
    log_evidence: float              # evidence at the optimum (subsample)
    nll_history: np.ndarray          # per-step loss trajectory
    w0: float
    w: float
    b: float
    num_points: int                  # subsample size the evidence scored
    depth: int = 1
    activation: str = "relu"
    # ARD: the learned per-feature input scale (None in scalar mode). The
    # kernel was learned on x * feature_scale: apply `scale_inputs` to
    # every x that meets this spec (fit, predict, extend).
    feature_scale: Optional[np.ndarray] = None
    # which evidence was maximized: "exact" or "dtc"
    objective: str = "exact"
    # provenance of a --hyper_file artifact: the kernel type the evidence
    # was computed under and the feature width it was learned on (None in
    # an artifact older than these fields)
    get: str = "nngp"
    num_features: Optional[int] = None

    def spec_params(self) -> dict:
        """The learned Dense stds, in layer order."""
        denses = [l for l in self.spec.layers if isinstance(l, Dense)]
        return {
            "w_stds": np.asarray([d.w_std for d in denses], np.float64),
            "b_stds": np.asarray([d.b_std for d in denses], np.float64),
        }

    def fit_kwargs(self) -> dict:
        """kwargs for `fit_gp`. b != 0 breaks scale equivariance, so the
        input prescale stays off."""
        kw = dict(diag_reg=self.diag_reg)
        if self.b != 0.0:
            kw["input_scale"] = 1.0
        return kw

    def scale_inputs(self, x):
        """x times the learned ARD feature scale (identity in scalar
        mode), for a tensor or a numpy array."""
        if self.feature_scale is None:
            return x
        if isinstance(x, torch.Tensor):
            return x * torch.as_tensor(self.feature_scale, dtype=x.dtype,
                                       device=x.device)
        x = np.asarray(x)
        return x * np.asarray(self.feature_scale).astype(x.dtype)

    def to_json(self) -> str:
        """The JSON artifact, in the JAX package's format: either package
        loads what the other wrote."""
        denses = [l for l in self.spec.layers if isinstance(l, Dense)]
        return json.dumps({
            "w0": self.w0, "w": self.w, "b": self.b,
            "diag_reg": self.diag_reg,
            "log_evidence": self.log_evidence,
            "num_points": self.num_points,
            "depth": self.depth, "activation": self.activation,
            "width": denses[0].width,
            "objective": self.objective,
            "get": self.get,
            "num_features": self.num_features,
            "feature_scale": (None if self.feature_scale is None else
                              np.asarray(self.feature_scale,
                                         np.float64).tolist()),
            "nll_history": np.asarray(self.nll_history,
                                      np.float64).tolist(),
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "HyperoptResult":
        d = json.loads(text)
        fs = (None if d["feature_scale"] is None
              else np.asarray(d["feature_scale"], np.float64))
        spec = KernelSpec(_build_layers(d["depth"], d["activation"],
                                        d["width"], d["w0"], d["w"], d["b"]))
        return cls(spec=spec, diag_reg=float(d["diag_reg"]),
                   log_evidence=float(d["log_evidence"]),
                   nll_history=np.asarray(d["nll_history"], np.float64),
                   w0=float(d["w0"]), w=float(d["w"]), b=float(d["b"]),
                   num_points=int(d["num_points"]), depth=int(d["depth"]),
                   activation=d["activation"], feature_scale=fs,
                   objective=d["objective"],
                   get=d.get("get", "nngp"),
                   num_features=(int(d["num_features"])
                                 if d.get("num_features") is not None
                                 else None))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "HyperoptResult":
        with open(path) as f:
            return cls.from_json(f.read())


def fit_kernel_hyperparams(x, y, depth: int = 1, activation: str = "relu",
                           get: str = "nngp", steps: int = 100,
                           lr: float = 0.1,
                           max_points: Optional[int] = 4096,
                           seed: int = 0, width: int = 512,
                           init: Tuple[float, float, float, float] =
                           (1.0, 1.0, 0.1, 1e-3),
                           reg_restarts: Tuple[float, ...] =
                           (1e-3, 3e-2, 0.3),
                           eps: Optional[float] = None,
                           ard: bool = False,
                           init_feature_scale=None,
                           objective: str = "exact",
                           dtc_m: int = 512,
                           mesh=None,
                           mm_jitter_rel: Optional[float] = None,
                           device=None) -> HyperoptResult:
    """Learn (w0, w, b, diag_reg) for an `mlp(depth, activation)` kernel by
    maximizing the log evidence on a seeded subsample of (x, y), with the
    arguments and defaults of the JAX function, plus `device` (where the
    optimization runs; required for numpy input, and a tensor's own device
    by default).

      * inputs are used as they are: run on [0, 1000]-scale or chunk_norm
        features. fp32 features beyond 2^20 raise ValueError (their
        squared Gram entries overflow, and the learned spec is not scale
        equivariant, so no prescale can rescue it).
      * init = (w0, w, b, diag_reg); all four are log-parameterized.
        `reg_restarts` are further initial ridges, run as one batch beside
        init's own; the best final evidence wins.
      * ard=True learns a per-feature input scale (the result's
        `feature_scale`; `init_feature_scale` seeds it).
      * objective='dtc' maximizes the DTC/Nystrom evidence with dtc_m
        inducing rows (a seeded permutation's prefix); mm_jitter_rel
        overrides its K_mm jitter.
      * max_points=None disables the subsample (sensible with 'dtc',
        whose cost is linear in n).
      * mesh (a `parallel.make_mesh` DeviceMesh; objective='dtc' only):
        the rows are split over the ranks, padded to a multiple of the
        mesh size with mask-0 rows, and the DTC loss's row sums and the
        gradients are summed over ranks. Collective: every rank passes the
        same x and y; the device is the mesh's.

    The subsample and the DTC permutation come from numpy generators
    seeded as in the JAX package, so both score the same rows. Raises
    FloatingPointError when every restart diverged."""
    if mesh is not None:
        if objective != "dtc":
            raise ValueError(
                "mesh-sharded hyperopt requires objective='dtc': the exact "
                "O(n^3) loss is not row-shardable")
        from nngp_tpu_torch.parallel.mesh import (check_mesh_device,
                                                  mesh_device)
        if device is not None:
            check_mesh_device(mesh, device)
        device = mesh_device(mesh)
    if device is None:
        if not isinstance(x, torch.Tensor):
            raise ValueError("fit_kernel_hyperparams needs device= for "
                             "numpy input")
        device = x.device
    device = resolve_device(device)
    x = _as_tensor(x, device)
    y = _as_tensor(y, device, x.dtype)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if x.numel() == 0:
        max_abs = 0.0
    elif ard and init_feature_scale is not None:
        scale = torch.as_tensor(np.asarray(init_feature_scale, np.float64),
                                device=device)
        max_abs = float(torch.max(torch.abs(x).double() * scale))
    else:
        max_abs = float(torch.max(torch.abs(x)))
    if x.dtype != torch.float64 and max_abs > 2.0 ** 20:
        raise ValueError(
            f"fit_kernel_hyperparams: max|feature| = {max_abs:.3g} "
            "overflows squared fp32 Gram entries; encode with "
            "chunk_norm=True (or pass fp64 inputs)")
    if y.dim() == 1:
        y = y[:, None]
    n = x.shape[0]
    if max_points is not None and n > max_points:
        sel = np.sort(np.random.default_rng(seed).choice(
            n, size=max_points, replace=False))
        sel = torch.as_tensor(sel, device=device)
        x, y = x[sel], y[sel]
    if objective == "dtc":
        # the inducing set is the row prefix: permute once so it is a
        # uniform draw (the sorted subsample keeps dataset order)
        perm = torch.as_tensor(
            np.random.default_rng(seed + 1).permutation(int(x.shape[0])),
            device=device)
        x, y = x[perm].contiguous(), y[perm].contiguous()
    if eps is None:
        eps = 1e-12 if x.dtype == torch.float64 else 1e-6
    regs = [float(init[3])] + [float(r) for r in reg_restarts
                               if float(r) != float(init[3])]
    r_count = len(regs)
    full = dict(dtype=x.dtype, device=device)
    theta0s = {
        "log_w": torch.log(torch.full((r_count,), init[1], **full)),
        "log_b": torch.log(torch.full((r_count,), init[2], **full)),
        "log_reg": torch.log(torch.tensor(regs, **full)),
    }
    if ard:
        s0 = (torch.full((x.shape[1],), float(init[0]), **full)
              if init_feature_scale is None
              else torch.as_tensor(np.asarray(init_feature_scale), **full))
        theta0s["log_s"] = torch.log(s0)[None, :].expand(
            r_count, x.shape[1]).clone()
    else:
        theta0s["log_w0"] = torch.log(torch.full((r_count,), init[0],
                                                 **full))
    if objective not in ("exact", "dtc"):
        raise ValueError(
            f"objective must be 'exact' or 'dtc', got {objective!r}")
    dtc_m = min(int(dtc_m), int(x.shape[0])) if objective == "dtc" else 0
    n_scored = int(x.shape[0])
    shard = {}
    if mesh is not None:
        group = mesh.get_group()
        p, rank = dist.get_world_size(group), dist.get_rank(group)
        pad = (-n_scored) % p
        shard["x_m"] = x[:dtc_m].contiguous()
        mask = torch.cat([torch.ones(n_scored, **full),
                          torch.zeros(pad, **full)])
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        y = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
        rows = slice(rank * (x.shape[0] // p), (rank + 1) * (x.shape[0] // p))
        x, y = x[rows].contiguous(), y[rows].contiguous()
        shard.update(mask=mask[rows].contiguous(), group=group)
    theta, hist, final = _optimize(x, y, theta0s, depth, activation, width,
                                   get, steps, float(lr), float(eps),
                                   ard=ard, objective=objective,
                                   dtc_m=dtc_m, mm_jitter_rel=mm_jitter_rel,
                                   **shard)
    final = float(final)
    if not math.isfinite(final):
        # every restart diverged: argmin over all-inf picks restart 0,
        # which would report the un-learned init as a success
        raise FloatingPointError(
            "hyperopt: every restart diverged (non-finite loss at all "
            "inits) — check the features/labels for NaN/overflow, or "
            "widen init/reg_restarts")
    theta = {k: v.detach().cpu().numpy() for k, v in theta.items()}
    w = float(np.exp(theta["log_w"]))
    b = float(np.exp(theta["log_b"]))
    reg = float(np.exp(theta["log_reg"]))
    feature_scale = None
    if ard:
        w0 = 1.0
        feature_scale = np.exp(theta["log_s"].astype(np.float64))
    else:
        w0 = float(np.exp(theta["log_w0"]))
    spec = KernelSpec(_build_layers(depth, activation, width, w0, w, b))
    return HyperoptResult(
        spec=spec, diag_reg=reg, log_evidence=-final,
        nll_history=hist.cpu().numpy(), w0=w0, w=w, b=b,
        num_points=n_scored, depth=depth, activation=activation,
        feature_scale=feature_scale, objective=objective,
        get=get, num_features=int(x.shape[1]))


def select_kernel(x, y, depths: Tuple[int, ...] = (1, 2, 3),
                  activations: Tuple[str, ...] = ("relu", "erf"),
                  get: str = "nngp", verbose=None,
                  **kwargs) -> Tuple[HyperoptResult, list]:
    """Model selection by evidence: `fit_kernel_hyperparams` for every
    (depth, activation), ranked by log evidence. Returns (best, all
    results, best first). The evidences are comparable because every run
    scores the same seeded subsample (`seed`/`max_points` in kwargs)."""
    results = []
    for d in depths:
        for a in activations:
            res = fit_kernel_hyperparams(x, y, depth=d, activation=a,
                                         get=get, **kwargs)
            results.append(res)
            if verbose:
                verbose(f"depth={d} act={a}: log evidence "
                        f"{res.log_evidence:.2f} (w0={res.w0:.3f} "
                        f"w={res.w:.3f} b={res.b:.3f} "
                        f"reg={res.diag_reg:.2e})")
    results.sort(key=lambda r: r.log_evidence, reverse=True)
    return results[0], results
