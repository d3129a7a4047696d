"""Uncertainty calibration: expected vs observed confidence levels,
post-hoc recalibration, and distribution-free conformal intervals.

A copy of `nngp_tpu/eval/calibration.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

`calibration_table` is the vectorized version of
`reference/util.py:296-313` — for each confidence level p the Gaussian
central interval is mean +/- z_{(1+p)/2} * std; the observed level is the
fraction of targets inside it. The reference loops per-query calling
scipy.stats.norm.interval; here it is one broadcasted comparison (and
erfinv replaces the scipy dependency).

Beyond the reference (which only REPORTS calibration, never fixes it):
  * `fit_std_scale` — closed-form MLE std recalibration: the Gaussian
    likelihood of the held-out residuals is maximized at
    c = sqrt(mean(((y - mu)/std)^2)), so returning c*std makes the
    z-scores unit-variance (temperature scaling for GP posteriors).
  * `conformal_scores` / `conformal_quantile` — split-conformal intervals
    on the std-normalized residual score |y - mu|/std: for n calibration
    points, mean +/- qhat*std with qhat the ceil((n+1)(1-alpha))/n
    empirical quantile covers a fresh exchangeable query with probability
    >= 1-alpha, with NO Gaussianity assumption (the classical split-
    conformal guarantee; std-scaling the score keeps intervals adaptive —
    uncertain queries get wider intervals).
"""

from typing import Dict

import numpy as np
from scipy import special


def calibration_table(y_true, means, stds, num_intervals: int = 10) -> Dict[float, float]:
    y = np.ravel(np.asarray(y_true, dtype=np.float64))
    mu = np.ravel(np.asarray(means, dtype=np.float64))
    sd = np.ravel(np.asarray(stds, dtype=np.float64))
    levels = np.array([i / num_intervals for i in range(num_intervals + 1)])
    # z for central coverage p: sqrt(2) * erfinv(p)
    z = np.sqrt(2.0) * special.erfinv(levels)
    with np.errstate(invalid="ignore"):
        bound = z[:, None] * sd[None, :]
    # p=1.0 gives z=inf; inf * 0 = NaN for zero-std queries, which would
    # count as OUTSIDE an infinite interval — the central interval at p=1
    # contains everything by definition
    bound[np.isinf(z), :] = np.inf
    inside = np.abs(y - mu)[None, :] <= bound
    observed = inside.mean(axis=1)
    return {float(p): float(o) for p, o in zip(levels, observed)}


def calibration_mae(table: Dict[float, float]) -> float:
    """Mean |expected - observed| over the table's interior levels (the
    0 and 1 endpoints are trivially exact and would dilute the score)."""
    pairs = [(p, o) for p, o in table.items() if 0.0 < p < 1.0]
    if not pairs:
        return 0.0
    return float(np.mean([abs(p - o) for p, o in pairs]))


def _zscores(y_true, means, stds, eps: float = 1e-12) -> np.ndarray:
    y = np.ravel(np.asarray(y_true, dtype=np.float64))
    mu = np.ravel(np.asarray(means, dtype=np.float64))
    sd = np.maximum(np.ravel(np.asarray(stds, dtype=np.float64)), eps)
    return (y - mu) / sd


def fit_std_scale(y_true, means, stds, eps: float = 1e-12) -> float:
    """Closed-form MLE std recalibration scale on held-out labels.

    Under y ~ N(mu, (c*std)^2) the likelihood over the calibration set is
    maximized at c^2 = mean(((y - mu)/std)^2) — one pass, no iteration.
    Serve c*std instead of std: >1 fixes overconfidence, <1 fixes
    underconfidence (measured on forest: the default kernel is UNDER-
    confident, learned hypers flip it overconfident — BASELINE.md)."""
    z = _zscores(y_true, means, stds, eps)
    if z.size == 0:
        return 1.0
    return float(np.sqrt(np.mean(z * z)))


def conformal_scores(y_true, means, stds, eps: float = 1e-12) -> np.ndarray:
    """Sorted split-conformal nonconformity scores |y - mu|/std for a
    held-out calibration set. Keep the array; `conformal_quantile` turns it
    into the interval half-width multiplier for any alpha."""
    return np.sort(np.abs(_zscores(y_true, means, stds, eps)))


def conformal_quantile(scores: np.ndarray, alpha: float = 0.1) -> float:
    """Finite-sample conformal quantile qhat: mean +/- qhat*std covers a
    fresh exchangeable point with probability >= 1-alpha. Returns inf when
    the calibration set is too small for the requested alpha
    (ceil((n+1)(1-alpha)) > n) — the honest answer, not an approximation."""
    scores = np.asarray(scores, dtype=np.float64)
    n = scores.size
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    k = int(np.ceil((n + 1) * (1.0 - alpha)))
    if n == 0 or k > n:
        return float("inf")
    return float(np.sort(scores)[k - 1])
