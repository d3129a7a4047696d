"""Exact GP posterior with neural-tangents `gradient_descent_mse_ensemble`
t = infinity semantics (PyTorch counterpart of `nngp_tpu/gp/posterior.py`,
exact tier).

  get='nngp' (Bayesian NNGP posterior):
      mean = K_*t (K_tt + r I)^-1 Y
      cov  = K_** - K_*t (K_tt + r I)^-1 K_t*
  get='ntk'  (infinite-time gradient-descent ensemble):
      mean = T_*t (T_tt + r I)^-1 Y
      cov  = K_** + T_*t T^-1 K_tt T^-1 T_t* - T_*t T^-1 K_t* - K_*t T^-1 T_t*
  with r = diag_reg * mean(diag(solve kernel))   (relative ridge)

K is the NNGP kernel, T (Theta) the NTK, and T^-1 abbreviates
(T_tt + r I)^-1.

Fit: `gram_sym` builds the ridged solve Gram (exact diagonal + r fused in,
both triangles written), `torch.linalg.cholesky` factors it (cuSOLVER on
CUDA) and two `torch.linalg.solve_triangular` calls give alpha. Predict:
`gram_cross` gives K_*t; the solves are cuBLAS trsm. The 10.8k forest Gram
is 467 MB in fp32, so the factor stays one dense tensor on an 80 GB card.
Extend: `gram_cross` gives K21 and `gram_sym` K22, and
`ops.linalg.cholesky_append_rows` appends them to the factor. A factor that
fails (fit or extend) raises `ops.linalg.FactorError`.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from nngp_tpu_torch.models.kernel_spec import (KernelSpec, diag_eval,
                                               is_scale_equivariant)
from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym
from nngp_tpu_torch.ops.linalg import FactorError, cholesky_append_rows
from nngp_tpu_torch.utils.device import resolve_device


# Rows (columns) of an fp32 factor converted to fp64 at a time by the
# solves and products of an fp64 right-hand side (`_tri_solve`, `_mm_wide`)
_WIDE_BLOCK = 4096


def _tri_solve(l, b, transpose=False):
    """L^-1 b, or L^-T b with transpose=True, for lower-triangular L. A
    right-hand side of a wider dtype than L's (fp64 against an fp32
    factor) is solved in its own dtype by block substitution, L converted
    one _WIDE_BLOCK-column panel at a time: no (n, n) fp64 copy."""
    if b.dtype == l.dtype:
        if transpose:
            return torch.linalg.solve_triangular(l.mT, b, upper=True)
        return torch.linalg.solve_triangular(l, b, upper=False)
    x = b.clone(memory_format=torch.contiguous_format)
    n = l.shape[0]
    starts = range(0, n, _WIDE_BLOCK)
    for s in (reversed(starts) if transpose else starts):
        e = min(s + _WIDE_BLOCK, n)
        diag = l[s:e, s:e].to(b.dtype)
        if transpose:
            x[s:e] = torch.linalg.solve_triangular(diag.mT, x[s:e],
                                                   upper=True)
            if s:
                x[:s].sub_(l[s:e, :s].to(b.dtype).mT @ x[s:e])
        else:
            x[s:e] = torch.linalg.solve_triangular(diag, x[s:e],
                                                   upper=False)
            if e < n:
                x[e:].sub_(l[e:, s:e].to(b.dtype) @ x[s:e])
    return x


def _mm_wide(a, b):
    """a @ b in b's dtype for an a of a narrower one, a's rows converted
    _WIDE_BLOCK at a time."""
    if a.dtype == b.dtype:
        return a @ b
    out = b.new_empty((a.shape[0], b.shape[1]))
    for s in range(0, a.shape[0], _WIDE_BLOCK):
        out[s:s + _WIDE_BLOCK] = a[s:s + _WIDE_BLOCK].to(b.dtype) @ b
    return out


@dataclasses.dataclass
class GPPosterior:
    """Fitted GP posterior state, all tensors on one device."""

    x_train: torch.Tensor            # (n, d), stored divided by input_scale
    y_train: torch.Tensor            # (n, 1)
    l: torch.Tensor                  # (n, n) lower Cholesky of solve-kernel + r I
    alpha: torch.Tensor              # (n, 1) (solve-kernel + r I)^-1 Y
    reg: torch.Tensor                # scalar ridge actually added
    k_tt_nngp: Optional[torch.Tensor]  # (n, n) train NNGP Gram; get='ntk' only
    spec: KernelSpec
    get: str = "nngp"
    diag_reg: float = 1e-3
    # Power-of-two input prescale (fp32 overflow guard): x_train is stored
    # divided by it and every incoming x is divided on entry. For
    # scale-equivariant specs the Grams scale by exactly scale^-2, so the
    # mean is invariant and std/cov are multiplied back on exit.
    input_scale: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.x_train.device

    @property
    def num_train(self) -> int:
        return self.x_train.shape[0]

    def _as_input(self, x):
        """x_test as a contiguous tensor of the posterior's dtype on its
        device. numpy input is copied there; a tensor on another device
        raises."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"x_test is on {x.device}, the posterior on "
                                 f"{self.device}")
            return x.to(self.x_train.dtype).contiguous()
        return torch.as_tensor(np.asarray(x), dtype=self.x_train.dtype,
                               device=self.device).contiguous()

    # -------------------------------------------------------------- predict
    @property
    def _raw64(self) -> bool:
        """fp32 with an input prescale: the variance is computed in fp64,
        its kernels on the raw rows (`raw_fp64`)."""
        return needs_raw_fp64(self.input_scale, self.x_train.dtype)

    def _predict_scaled(self, x_test, compute_cov):
        """Predict body for raw-unit x_test in prescaled units: the mean is
        exact in raw units, var/cov come back divided by input_scale^2.

        With an fp32 input prescale the variance runs in fp64: its kernels
        through `raw_fp64`, the solves against the fp32 factor by block
        substitution (`_tri_solve`), the result rounded to fp32. The mean
        keeps the prescaled fp32 cross Gram."""
        x_raw = self._as_input(x_test)
        x_test = x_raw
        if self.input_scale != 1.0:
            x_test = x_raw * (1.0 / self.input_scale)
        layers, spec, dtype = self.spec.layers, self.spec, self.x_train.dtype
        wide = self._raw64

        def var_kernels(fn):
            if wide:
                return raw_fp64(fn, x_raw, self.x_train, self.input_scale)
            return fn(x_test, self.x_train)

        def k_diag(xs, _):
            return diag_eval(layers, xs, "nngp")

        def k_ss(xs, _):
            return gram_sym(spec, xs, "nngp")           # exact diagonal

        if self.get == "nngp":
            cross = gram_cross(spec, x_test, self.x_train, "nngp")  # (m, n)
            mean = cross @ self.alpha
            if compute_cov is False:
                return mean
            if wide:
                cross = var_kernels(lambda a, b: gram_cross(spec, a, b,
                                                            "nngp"))
            v = _tri_solve(self.l, cross.mT)  # (n, m)
            if compute_cov == "diag":
                var = var_kernels(k_diag) - torch.sum(v * v, dim=0)
                return mean, torch.clamp_min(var, 0.0).to(dtype)
            return mean, (var_kernels(k_ss) - v.mT @ v).to(dtype)

        pair = ("nngp", "ntk")
        nngp_cross, ntk_cross = gram_cross(spec, x_test, self.x_train, pair)
        mean = ntk_cross @ self.alpha
        if compute_cov is False:
            return mean
        if wide:
            nngp_cross, ntk_cross = var_kernels(
                lambda a, b: gram_cross(spec, a, b, pair))
        # w = (T + rI)^-1 T_t* via two triangular solves, shape (n, m)
        w = _tri_solve(self.l, _tri_solve(self.l, ntk_cross.mT),
                       transpose=True)
        kw = _mm_wide(self.k_tt_nngp, w)             # K_tt T^-1 T_t*, (n, m)
        if compute_cov == "diag":
            var = (var_kernels(k_diag)
                   + torch.sum(w * kw, dim=0)
                   - 2.0 * torch.sum(nngp_cross.mT * w, dim=0))
            return mean, torch.clamp_min(var, 0.0).to(dtype)
        cross_term = nngp_cross @ w                  # K_*t T^-1 T_t*, (m, m)
        return mean, (var_kernels(k_ss) + w.mT @ kw - cross_term
                      - cross_term.mT).to(dtype)

    def predict(self, x_test, compute_cov=True):
        """Posterior (mean, cov) at x_test, in raw input units.

        compute_cov: True -> full (m, m) covariance; 'diag' -> (m,)
        variances; False -> mean only. With an input prescale s the raw
        variance is var_scaled * s^2, which can leave fp32's range; use
        `predict_mean_std`, which compensates after the sqrt."""
        if compute_cov not in (True, False, "diag"):
            raise ValueError(f"compute_cov must be True, False or 'diag', "
                             f"got {compute_cov!r}")
        out = self._predict_scaled(x_test, compute_cov)
        if compute_cov is False or self.input_scale == 1.0:
            return out
        mean, v = out
        return mean, v * (self.input_scale * self.input_scale)

    def predict_mean_std(self, x_test):
        """(mean (m, 1), std (m,)) with the variance clamped at zero."""
        mean, var = self._predict_scaled(x_test, "diag")
        return mean, torch.sqrt(var) * self.input_scale

    def predict_mean_std_chunked(self, x_test, chunk: int = 8192):
        """(mean, std) as 1-D numpy arrays over any number of test rows,
        `chunk` rows per predict so the cross Gram stays chunk x n."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        means, stds = [], []
        for s in range(0, x_test.shape[0], chunk):
            mean, std = self.predict_mean_std(x_test[s:s + chunk])
            means.append(mean.reshape(-1).cpu().numpy())
            stds.append(std.reshape(-1).cpu().numpy())
        return np.concatenate(means), np.concatenate(stds)

    # ------------------------------------------------------- model evidence
    def log_marginal_likelihood(self) -> float:
        """Exact GP log evidence log p(y | X) in raw input units:
        -0.5 (y^T alpha + 2 sum log diag L + n log 2 pi). With a prescale
        the stored system is the raw one divided by scale^2, so the logdet
        gains n log scale^2 and the quadratic term is divided by scale^2."""
        n = self.num_train
        quad = float(torch.sum(self.y_train * self.alpha))
        logdet = float(2.0 * torch.sum(torch.log(torch.diagonal(self.l))))
        if self.input_scale != 1.0:
            s2 = float(self.input_scale) ** 2
            quad /= s2
            logdet += n * math.log(s2)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    # --------------------------------------------------------------- extend
    def extend(self, x_new, y_new) -> "GPPosterior":
        """A new posterior with m labeled rows appended by an O(n^2 m)
        block-Cholesky update instead of a refit (`_extend_dense` of the
        JAX package). x_new is in raw input units, like a predict input.

        The fit's ridge is kept: a relative ridge is defined by the
        fit-time Gram, and deriving it again from the extended Gram would
        change the model the factor represents. K22 gets the exact
        diagonal from `gram_sym`, as the fit's Gram did. This posterior is
        not modified."""
        x_new = self._as_input(x_new)
        if x_new.dim() != 2 or x_new.shape[0] < 1 \
                or x_new.shape[1] != self.x_train.shape[1]:
            raise ValueError(f"x_new must be (m >= 1, {self.x_train.shape[1]})"
                             f", got {tuple(x_new.shape)}")
        y_new = _as_tensor(y_new, self.device, self.x_train.dtype)
        if y_new.dim() == 1:
            y_new = y_new[:, None]
        if y_new.shape != (x_new.shape[0], self.y_train.shape[1]):
            raise ValueError(f"y_new has shape {tuple(y_new.shape)} for "
                             f"{x_new.shape[0]} rows")
        if self.input_scale != 1.0:
            x_new = x_new * (1.0 / self.input_scale)
        if self.get == "nngp":
            k21 = gram_cross(self.spec, x_new, self.x_train, "nngp")
            k22 = gram_sym(self.spec, x_new, "nngp", diag_add=self.reg)
        else:
            n21, k21 = gram_cross(self.spec, x_new, self.x_train,
                                  ("nngp", "ntk"))
            n22, k22 = gram_sym(self.spec, x_new, ("nngp", "ntk"),
                                diag_add=self.reg)
        try:
            l = cholesky_append_rows(self.l, k21, k22)
        except FactorError as err:
            err.diag_reg = self.diag_reg
            raise
        y = torch.cat([self.y_train, y_new])
        alpha = _tri_solve(l, _tri_solve(l, y), transpose=True)
        k_tt = None
        if self.get == "ntk":
            # filled block by block: no (n, n + m) temporary at the peak
            n = self.k_tt_nngp.shape[0]
            k_tt = self.k_tt_nngp.new_empty((n + n22.shape[0],) * 2)
            k_tt[:n, :n] = self.k_tt_nngp
            k_tt[n:, :n] = n21
            k_tt[:n, n:] = n21.mT
            k_tt[n:, n:] = n22
        return dataclasses.replace(
            self, x_train=torch.cat([self.x_train, x_new]), y_train=y, l=l,
            alpha=alpha, k_tt_nngp=k_tt)


def needs_raw_fp64(input_scale: float, dtype) -> bool:
    """Whether a posterior's variance reads its test kernels through
    `raw_fp64`: fp32 with an input prescale."""
    return input_scale != 1.0 and dtype == torch.float32


def raw_fp64(fn, x_raw, x_train, input_scale: float):
    """fn(test rows, train rows) evaluated in fp64 on the raw rows (x_raw
    in raw units, x_train stored divided by input_scale), its fp64 outputs
    multiplied by input_scale^-2 (exact: a power of two, and the spec is
    scale-equivariant): the prescaled-unit kernels, without the
    prescale's underflow.

    In prescaled units two rows without a packed chunk (|x| <= 1000
    against a 2^64 prescale) have k11 k22 ~ 1e-67, below the duals' 1e-36
    floor (fp32 or fp64 alike), so their cross entries came out ~1e15
    times too large and their variance negative: 13% of synth6's
    raw-encoding test stds clamped to zero (PERF.md, PR 11). Raw rows keep
    k11 k22 far above the floor. The posteriors use it for the variance
    only, solved in fp64 too (an fp32 solve of these kernels left the
    chunk-less rows' variance to fp32 noise on the card): the mean keeps
    the prescaled cross Gram, and the train Gram its floored entries,
    which lie 1e12 below the ridge."""
    s2 = 1.0 / (input_scale * input_scale)
    out = fn(x_raw.to(torch.float64),
             x_train.to(torch.float64) * input_scale)
    if isinstance(out, tuple):
        return tuple(k * s2 for k in out)
    return out * s2


# Features beyond this magnitude trigger the automatic input prescale in
# fp32 fits (scale-equivariant specs only): squared Gram entries of
# 2^64-packed categorical chunks overflow fp32. [0, 1000] workloads (forest)
# keep scale 1.0.
_PRESCALE_MAX_ABS = 2.0 ** 20


def input_scale_for_bound(max_abs: float, layers, fp64: bool = False) -> float:
    """Power-of-two prescale covering features of magnitude <= max_abs, or
    1.0 when the exact compensation does not apply (non-equivariant spec,
    fp64) or is not needed (small features)."""
    if fp64 or not is_scale_equivariant(layers):
        return 1.0
    m = float(max_abs)
    if not math.isfinite(m) or m <= _PRESCALE_MAX_ABS:
        return 1.0
    return float(2.0 ** math.ceil(math.log2(m)))


def _auto_input_scale(x, layers) -> float:
    """Data-probed prescale: `input_scale_for_bound` of max|x|. Free for
    numpy input; a CUDA tensor costs one device sync."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float64 or not is_scale_equivariant(layers):
            return 1.0
        m = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    else:
        x = np.asarray(x)
        if x.dtype == np.float64 or not is_scale_equivariant(layers):
            return 1.0
        m = float(np.max(np.abs(x))) if x.size else 0.0
    return input_scale_for_bound(m, layers)


def _as_tensor(a, device, dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=device).contiguous()


def solve_ridge(diag, get: str = "nngp", diag_reg: float = 1e-3,
                absolute_scale: bool = False) -> torch.Tensor:
    """The ridge r that `fit_gp` adds to the solve kernel's diagonal:
    diag_reg * mean of that kernel's exact diagonal, or diag_reg itself
    with absolute_scale. diag: the (nngp, ntk) pair of
    `diag_eval(layers, x, ("nngp", "ntk"))`."""
    solve_diag = diag[0] if get == "nngp" else diag[1]
    if absolute_scale:
        return torch.tensor(diag_reg, dtype=solve_diag.dtype,
                            device=solve_diag.device)
    return diag_reg * torch.mean(solve_diag)


def fit_gp(spec: KernelSpec, x_train, y_train, diag_reg: float = 1e-3,
           get: str = "nngp", diag_reg_absolute_scale: bool = False,
           input_scale: Optional[float] = None,
           device=None) -> GPPosterior:
    """Factorize the train Gram and return a ready posterior.

    x_train, y_train: numpy arrays or tensors (float32 or float64; the
    dtype of x_train is the working dtype). device: where the posterior
    lives; required for numpy input, and for a tensor it defaults to the
    tensor's own device.

    input_scale: None picks an automatic power-of-two prescale when fp32
    features would overflow the Gram; pass 1.0 to force raw features.

    A ridged Gram that is not positive definite in the working dtype
    raises `ops.linalg.FactorError` (a FloatingPointError naming n, the
    failing order, the dtype and diag_reg), after its n x n tensors are
    freed; the JAX fit returns a NaN factor there."""
    if get not in ("nngp", "ntk"):
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    if device is None:
        if not isinstance(x_train, torch.Tensor):
            raise ValueError("fit_gp needs device= for numpy input")
        device = x_train.device
    device = resolve_device(device)
    if input_scale is None:
        input_scale = _auto_input_scale(x_train, spec.layers)
    x = _as_tensor(x_train, device)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x_train must be float32 or float64, got {x.dtype}")
    y = _as_tensor(y_train, device, x.dtype)
    if y.dim() == 1:
        y = y[:, None]
    if input_scale != 1.0:
        x = x * (1.0 / input_scale)

    diag = diag_eval(spec.layers, x, ("nngp", "ntk"))
    reg = solve_ridge(diag, get, diag_reg, diag_reg_absolute_scale)
    if get == "nngp":
        solve_k = gram_sym(spec, x, "nngp", diag_add=reg, diag=diag)
        k_tt_nngp = None
    else:
        k_tt_nngp, solve_k = gram_sym(spec, x, ("nngp", "ntk"), diag_add=reg,
                                      diag=diag)
    l, info = torch.linalg.cholesky_ex(solve_k)
    del solve_k
    if int(info):
        # the traceback keeps this frame alive: drop the n x n tensors
        # first, so that a caller's fallback fit has the memory
        del l, k_tt_nngp
        raise FactorError("fit", int(info), x.shape[0], x.dtype, diag_reg)
    alpha = _tri_solve(l, _tri_solve(l, y), transpose=True)
    return GPPosterior(
        x_train=x, y_train=y, l=l, alpha=alpha, reg=reg,
        k_tt_nngp=k_tt_nngp, spec=spec, get=get, diag_reg=diag_reg,
        input_scale=float(input_scale))


def select_diag_reg(spec: KernelSpec, x_train, y_train,
                    candidates=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2),
                    get: str = "nngp", input_scale: Optional[float] = None,
                    device=None):
    """Ridge selection by exact GP evidence: refit per candidate and keep
    the `diag_reg` with the highest `log_marginal_likelihood`. At most one
    factor is alive at a time: each candidate is scored and dropped, and
    the winner is fitted again at the end.

    x_train, y_train and device as for `fit_gp`; the data go to the device
    once and the input prescale is resolved once. Returns
    (best_posterior, {diag_reg: log evidence})."""
    if device is None:
        if not isinstance(x_train, torch.Tensor):
            raise ValueError("select_diag_reg needs device= for numpy input")
        device = x_train.device
    device = resolve_device(device)
    if input_scale is None:
        input_scale = _auto_input_scale(x_train, spec.layers)
    x = _as_tensor(x_train, device)
    y = _as_tensor(y_train, device, x.dtype)
    scores = {}
    for r in candidates:
        try:
            post = fit_gp(spec, x, y, diag_reg=float(r), get=get,
                          input_scale=input_scale)
        except FactorError:
            # not positive definite at this ridge: where the JAX factor
            # comes out NaN, fit_gp raises; either way no evidence
            scores[float(r)] = math.nan
            continue
        scores[float(r)] = post.log_marginal_likelihood()
        del post
    finite = {r: v for r, v in scores.items() if math.isfinite(v)}
    if not finite:
        raise FloatingPointError(
            "no candidate diag_reg produced a finite evidence; check the "
            "feature scale and input_scale")
    best_r = max(finite, key=finite.get)
    return fit_gp(spec, x, y, diag_reg=best_r, get=get,
                  input_scale=input_scale), scores
