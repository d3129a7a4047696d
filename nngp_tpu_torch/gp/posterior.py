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
`ops.linalg.cholesky_append_rows` appends them to the factor.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from nngp_tpu_torch.models.kernel_spec import (KernelSpec, diag_eval,
                                               is_scale_equivariant)
from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym
from nngp_tpu_torch.ops.linalg import cholesky_append_rows
from nngp_tpu_torch.utils.device import resolve_device


def _tri_solve(l, b, transpose=False):
    """L^-1 b, or L^-T b with transpose=True, for lower-triangular L."""
    if transpose:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


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
    def _predict_scaled(self, x_test, compute_cov):
        """Predict body in prescaled input units: the mean is exact in raw
        units, var/cov come back divided by input_scale^2."""
        x_test = self._as_input(x_test)
        if self.input_scale != 1.0:
            x_test = x_test * (1.0 / self.input_scale)
        layers = self.spec.layers
        if self.get == "nngp":
            cross = gram_cross(self.spec, x_test, self.x_train, "nngp")  # (m, n)
            mean = cross @ self.alpha
            if compute_cov is False:
                return mean
            v = _tri_solve(self.l, cross.mT)  # (n, m)
            if compute_cov == "diag":
                var = diag_eval(layers, x_test, "nngp") - torch.sum(v * v, dim=0)
                return mean, torch.clamp_min(var, 0.0)
            k_ss = gram_sym(self.spec, x_test, "nngp")  # exact diagonal
            return mean, k_ss - v.mT @ v

        nngp_cross, ntk_cross = gram_cross(self.spec, x_test, self.x_train,
                                           ("nngp", "ntk"))
        mean = ntk_cross @ self.alpha
        if compute_cov is False:
            return mean
        # w = (T + rI)^-1 T_t* via two triangular solves, shape (n, m)
        w = _tri_solve(self.l, _tri_solve(self.l, ntk_cross.mT),
                       transpose=True)
        kw = self.k_tt_nngp @ w                      # K_tt T^-1 T_t*, (n, m)
        if compute_cov == "diag":
            var = (diag_eval(layers, x_test, "nngp")
                   + torch.sum(w * kw, dim=0)
                   - 2.0 * torch.sum(nngp_cross.mT * w, dim=0))
            return mean, torch.clamp_min(var, 0.0)
        k_ss = gram_sym(self.spec, x_test, "nngp")   # exact diagonal
        cross_term = nngp_cross @ w                  # K_*t T^-1 T_t*, (m, m)
        return mean, k_ss + w.mT @ kw - cross_term - cross_term.mT

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
        l = cholesky_append_rows(self.l, k21, k22)
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
    features would overflow the Gram; pass 1.0 to force raw features."""
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
    l = torch.linalg.cholesky(solve_k)
    del solve_k
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
        except torch.linalg.LinAlgError:
            # not positive definite at this ridge: where the JAX factor
            # comes out NaN, torch raises; either way no evidence
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
