"""Workload-drift detection for live serving (the WHEN of online learning).

A copy of `nngp_tpu/serve/drift.py` (numpy only). It is carried in this
package rather than imported because `nngp_tpu/serve/__init__.py` imports
the JAX Estimator, so importing any `nngp_tpu.serve` module loads jax.

The framework's online remediations are `extend_with_lines` (fold in
fresh labels) and, once ported, `relearn_hyperparams` (recalibrate the
kernel, ROADMAP Queue A #9) and `grow_inducing` (raise Nystrom capacity,
Queue A #10). The reference's deployment loop leaves WHEN to apply them to
the operator: its aux-feedback tool thresholds per-query q-error offline
(the reference's `neuroestimator/merge_subquery_card.py:56-58`). This
module closes that loop with a sequential change detector over the
serving feedback stream.

Signal: the absolute standardized residual |z| = |y - mu| / std of each
freshly-labeled query under the CURRENT posterior. For a well-specified
Gaussian posterior E|z| = sqrt(2/pi) ~= 0.798 regardless of query mix, so a
sustained rise means the model no longer explains the workload (data drift,
stale hyperparameters, or capacity exhaustion) — unlike raw q-error, whose
baseline level is workload-dependent.

Detector: Page-Hinkley on the |z| stream — cumulative sum of
(x_t - mean_t - delta) versus its running minimum; alarm when the gap
exceeds `threshold`. Page-Hinkley is the standard streaming mean-shift test:
O(1) state, no window to size, and `delta` gives slack so calibration noise
never alarms. The empirical mean is FROZEN after `warmup` observations —
otherwise a slow drift drags the baseline along and is never detected.

Remediation routing (the JAX package's measurements, BASELINE.md
round-3g): the exact tier relearns its hyperparameters, the Nystrom tier
grows its inducing set.
"""

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from nngp_tpu_torch.serve.follower import collective

__all__ = ["DriftMonitor", "DriftReport"]

# E|z| under a correctly-specified Gaussian posterior.
_EXPECTED_ABS_Z = math.sqrt(2.0 / math.pi)


@dataclasses.dataclass
class DriftReport:
    """Outcome of folding one feedback batch into the monitor."""
    drift: bool                  # alarm state after this batch
    action: Optional[str]        # recommended remediation method name
    mean_abs_z: float            # batch mean |z| (healthy ~= 0.8)
    median_q_error: float        # batch median q-error (reporting only)
    n_observed: int              # total observations folded so far
    ph_stat: float               # current Page-Hinkley statistic
    threshold: float


class DriftMonitor:
    """Page-Hinkley mean-shift detector over the |z| feedback stream.

    Parameters
    ----------
    delta : slack subtracted from every increment — shifts smaller than
        `delta` in mean |z| are ignored (default 0.15, ~19% of the healthy
        level: comfortably above the residual-calibration noise measured on
        the forest/synth6 feedback sets, well below the 2-5x inflation a
        real workload shift produces).
    threshold : alarm when the PH statistic exceeds this (default 15 —
        e.g. a sustained +0.4 shift in mean |z| alarms after ~60 queries,
        a +1.0 shift after ~18).
    warmup : observations used to estimate the baseline mean before it is
        frozen (default 128). Until then no alarm can fire.
    std_floor : stds below this are clamped before standardizing (a
        near-interpolated training point must not contribute a huge |z|
        from fp noise).
    """

    def __init__(self, delta: float = 0.15, threshold: float = 15.0,
                 warmup: int = 128, std_floor: float = 1e-3):
        if warmup < 1:
            raise ValueError("warmup must be >= 1")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.std_floor = float(std_floor)
        self.reset()

    @collective
    def reset(self):
        """Forget everything — call after a remediation so the detector
        evaluates the NEW posterior from scratch."""
        self.n = 0
        self._warm_sum = 0.0
        self._baseline = None     # frozen mean |z| after warmup
        self._cum = 0.0           # PH cumulative sum
        self._cum_min = 0.0
        self.drift = False

    @property
    def stat(self) -> float:
        return self._cum - self._cum_min

    def update(self, abs_z: Sequence[float]) -> bool:
        """Fold a batch of |z| observations; returns the alarm state.

        The alarm LATCHES: once drift is flagged it stays flagged until
        `reset()` — remediation is the only way back to healthy, matching
        how the serving loop consumes it."""
        for x in np.asarray(abs_z, dtype=np.float64).ravel():
            if not np.isfinite(x):
                continue
            self.n += 1
            if self._baseline is None:
                self._warm_sum += x
                if self.n >= self.warmup:
                    self._baseline = self._warm_sum / self.n
                continue
            self._cum += x - self._baseline - self.delta
            self._cum_min = min(self._cum_min, self._cum)
            if self._cum - self._cum_min > self.threshold:
                self.drift = True
        return self.drift
