"""Serving estimator: the PyTorch counterpart of
`nngp_tpu/serve/estimator.py`, with its exact and Nystrom tiers.

A DBMS hands over sub-query lines and gets back (mean, std) of the log2
cardinality of each. The constructor loads the schema stats and the
training queries, fits the posterior once on `device` (the exact GP, or
the streaming Nystrom/DTC tier with `nystrom_m` inducing rows, or the tier
`tier='auto'` picks by the train-set size), and `predict(query_lines)`
encodes the lines (native C++ encoder when g++ is present) and runs the
cross Gram kernel and the solves there. The fitted state is a checkpoint
(`save` / `Estimator.restore`) in the JAX package's single-chip and
Nystrom formats, so either package restores what the other wrote. Online
learning (`extend_with_lines`; on the Nystrom tier also
`forget_with_lines` and `grow_inducing`), uncertainty calibration and
drift monitoring work as in the JAX package.

Hyperparameters learned by evidence (`learn_hyper`, `hyper_ard`,
`quality='best'`) come from `gp.hyperopt`, against the evidence of the
tier that serves (DTC on the Nystrom tier); `relearn_hyperparams`
relearns them on a live server, warm-started, and rolls back on any
failure.

The distributed tier (`mesh=`, a `parallel.make_mesh` DeviceMesh) fits
and serves the row-sharded posterior of `parallel/`. Every rank then
builds the same Estimator and calls every method with the same arguments
(SPMD); checkpoints are written by rank 0 in the JAX package's distributed
format.

What differs from the JAX Estimator:
  - `exact_max_n`, the train-set size up to which `tier='auto'` keeps the
    exact tier, defaults to a bound derived from the card's memory
    (`default_exact_max_n`, under the column-block factor's peaks); 55,000
    on the CPU. The factor is dense up to `dense_exact_max_n` (28,000 on
    the CPU, the JAX package's switch) and column blocks above it;
  - the serving buckets are CUDA graphs (`serve/graphs.py`): on the card
    each bucket's predict is captured once and replayed, over a padded
    posterior (pad_slots) through in-place extends too (captured again
    when one moves its live order, `gp.posterior.live_rows`); a new
    posterior object (fit, refit, relearn, restore, a re-route, slots run
    out) drops them, and they are captured again at their next use. A batch
    above the largest bucket (8,192, less for large train sets) runs in
    chunks of it. The distributed tier predicts eagerly (its predict is
    collective over the mesh). `warmup` returns the buckets it captured;
  - pad_slots and `fit_gp(pad_to=)` are capped by `dense_exact_max_n`
    (the JAX package caps them at its column-block layout too); a padded
    exact fit in fp32 whose factor fails raises under tier='auto' instead
    of re-routing to the Nystrom tier;
  - `learn_hyper` takes None as its unset sentinel, so an explicit False
    survives `quality='best'` (the JAX package turns it into True);
  - the encoder in use is named by `encoder_kind`, and a fall-back to the
    Python encoder is printed;
  - an exact factor that fails (the ridged Gram is not positive definite
    in the working dtype) raises `ops.linalg.FactorError`, a
    FloatingPointError naming n, the failing order, the dtype and
    diag_reg, where the JAX Estimator's NaN factor fails `_validate_fit`
    with a FloatingPointError that names neither; an extend that fails so
    keeps the old posterior, as a non-finite one does;
  - under tier='auto' an fp32 exact fit whose factor fails is refitted on
    the Nystrom tier that 'auto' takes beyond exact_max_n, with a printed
    and warned `tier routing:` line that gives the reason. On the card
    the fp32 factor of synth6_big's rows fails at the default ridge at
    orders from 32,897 (40k rows) to 72,606 (all 90k), where the memory
    rule admits ~126k, and depends on the rows' order (PERF.md §6), so
    no cap by n would do. Hyperparameters learned against the
    exact evidence are relearned against the DTC evidence first;
    `relearn_hyperparams` never re-routes (it rolls back and raises).
"""

import collections
import json
import os
import sys
import threading
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nngp_tpu_torch.featurize.join import MultiJoinEncoder
from nngp_tpu_torch.featurize.stats import TableStats
from nngp_tpu_torch.convert import (distributed_from_numpy,
                                    distributed_to_numpy,
                                    nystrom_from_numpy, nystrom_to_numpy,
                                    posterior_from_numpy, posterior_to_numpy)
from nngp_tpu_torch.data.workload import schema_stats, schema_stats_from_csvs
from nngp_tpu_torch.gp.nystrom import (NystromPosterior, _resolve_finalize,
                                       fit_nystrom)
from nngp_tpu_torch.gp.posterior import (  # noqa: F401 (the rule's names)
    DENSE_PEAK_BYTES_PER_N2, EXACT_PEAK_BYTES_PER_N2, GPPosterior,
    default_exact_max_n, dense_exact_max_n, fit_gp, uses_block_layout)
from nngp_tpu_torch.models.kernel_spec import (Activation, Dense, KernelSpec,
                                               reference_kernel)
from nngp_tpu_torch.ops.linalg import BlockLowerTriangular, FactorError
from nngp_tpu_torch.parallel.mesh import check_mesh_device, is_lead
from nngp_tpu_torch.parallel.sharded import (DistributedPosterior,
                                             distributed_fit)
from nngp_tpu_torch.serve.follower import collective
from nngp_tpu_torch.serve.graphs import BucketGraphs, buckets_upto
from nngp_tpu_torch.utils.device import resolve_device
from nngp_tpu_torch.utils.profiling import span

# Scaled-feature magnitude ceiling for incremental extends, mirroring the
# fit-time prescale threshold (`gp.posterior._PRESCALE_MAX_ABS`): beyond it
# squared fp32 Gram entries head toward overflow.
_EXTEND_MAX_SCALED_ABS = 2.0 ** 20


def _spec_to_json(spec: KernelSpec):
    out = []
    for layer in spec.layers:
        if isinstance(layer, Dense):
            out.append({"dense": [layer.width, layer.w_std, layer.b_std]})
        else:
            out.append({"activation": layer.name})
    return out


def _spec_from_json(items) -> KernelSpec:
    layers = []
    for it in items:
        if "dense" in it:
            w, ws, bs = it["dense"]
            layers.append(Dense(int(w), float(ws), float(bs)))
        else:
            layers.append(Activation(it["activation"]))
    return KernelSpec(tuple(layers))


def _checkpoint_factor(meta, arrs, device, get):
    """The factor of a checkpoint: a dense array, or a column-block factor
    (`l_block_starts`, block k = L[s_k:, s_k:s_{k+1}]) that stays blocks
    where `fit_gp` would factor its n rows so (`uses_block_layout`) and is
    assembled into one dense array below that."""
    if "l_block_starts" not in meta:
        return np.asarray(arrs["l"])
    starts = [int(s) for s in meta["l_block_starts"]]
    blocks = [np.asarray(arrs[f"l_block_{i}"]) for i in range(len(starts) - 1)]
    n = starts[-1]
    if uses_block_layout(n, device, blocks[0].dtype, get):
        return BlockLowerTriangular(blocks, starts, n)
    l = np.zeros((n, n), dtype=blocks[0].dtype)
    for s, blk in zip(starts, blocks):
        l[s:, s:s + blk.shape[1]] = blk
    return l


class Estimator:
    # Cross-call prediction memo capacity (entries). A class attribute so
    # restored instances (built via __new__) get it too; override per
    # instance with the `predict_cache_size` constructor argument.
    predict_cache_size = 4096
    # Configuration-routing mode (restored instances report one too).
    quality = "reference"

    @property
    def posterior(self):
        return self._posterior

    @posterior.setter
    def posterior(self, value):
        # EVERY install (fit, extend, restore, rollback) drops the
        # prediction memo, whose stale entries would serve the old model's
        # answers; a new posterior object also drops the serving buckets'
        # graphs, which read the old one's tensors. The one change made in
        # place, a padded posterior's extend, empties the memo itself and
        # keeps the BucketGraphs (`extend_with_lines`), which capture their
        # buckets again when the extend has moved the live order
        # (`serve/graphs.py`).
        if "_serve_lock" not in self.__dict__:
            # predicts, captures and in-place extends take it
            self._serve_lock = threading.RLock()
        if value is not self.__dict__.get("_posterior"):
            self._graphs = None
        self._posterior = value
        self._pred_cache = collections.OrderedDict()

    def __init__(self, schema_name: str, data_path: Optional[str],
                 train_query_path: str, chunk_size: int = 64,
                 use_aux: bool = False, q_error_threshold: float = 100.0,
                 coef_var_threshold: float = 1.0, kernel_type: str = "nngp",
                 diag_reg: float = 1e-3, spec: Optional[KernelSpec] = None,
                 stats: Optional[Sequence[TableStats]] = None,
                 stats_dir: Optional[str] = None, dtype=np.float32,
                 verbose: bool = True, mesh=None,
                 dist_block_size: Optional[int] = None,
                 chunk_norm: Optional[bool] = None,
                 nystrom_m: Optional[int] = None,
                 nystrom_moments: Optional[str] = None,
                 learn_hyper=None, hyper_steps: int = 100,
                 hyper_points: int = 4096, hyper_ard: Optional[bool] = None,
                 hyper_objective: str = "auto",
                 predict_cache_size: int = 4096,
                 pad_slots: Optional[int] = None,
                 quality: str = "reference",
                 calibrate_frac: Optional[float] = None,
                 calibrate_seed: int = 7, tier: Optional[str] = None,
                 auto_nystrom_m: int = 2048,
                 exact_max_n: Optional[int] = None, *, device):
        """The arguments of the JAX Estimator, plus `device` (required;
        'cuda' without a GPU raises).

        pad_slots (single-device exact nngp tier only): the fit pads its
        storage with this many inert rows (`fit_gp(pad_to=n + pad_slots)`)
        and `extend_with_lines` buckets each feedback batch to a power of
        two written into the slots in place, so the serving buckets'
        CUDA graphs stay valid across online feedback, each captured again
        only when n_real crosses a `gp.posterior.LIVE_STEP`. When the slots
        run out the posterior falls back to dense appends (a new posterior,
        new graphs).

        mesh: a `parallel.make_mesh` DeviceMesh on `device`'s type: fit and
        serve with the row-sharded distributed posterior
        (`parallel.distributed_fit`, panel width dist_block_size), or with
        nystrom_m the Nystrom tier's moments streamed over the mesh.
        Collective: every rank constructs the Estimator with the same
        arguments.

        nystrom_m: fit the streaming Nystrom/DTC tier (`gp.nystrom`) with
        this many inducing rows instead of the exact posterior: O(m^2)
        device state at any n. nystrom_moments: its moment precision,
        'fp32' (default) or 'df64' (fp64 kernel entries, bases,
        projections and accumulators on an fp32 posterior).

        tier: None derives the tier from the flags (nystrom_m set ->
        Nystrom, mesh set -> distributed, else exact). 'auto' keeps the
        exact tier (the distributed one with a mesh) while the fitted row
        count is at most exact_max_n (None: `default_exact_max_n` of the
        device, dtype and kernel_type), then the distributed tier with a
        mesh, and routes larger train sets to the Nystrom tier with
        auto_nystrom_m inducing rows (and moments 'df64' under
        quality='best' in fp32). An fp32 exact fit that 'auto' chose and
        whose factor fails goes to that Nystrom tier too (printed and
        warned, with the reason). 'exact', 'nystrom' and 'distributed'
        force a tier ('distributed' requires mesh); a failed exact factor
        raises `ops.linalg.FactorError` (a FloatingPointError).

        learn_hyper: True learns (w0, w, b, diag_reg) by exact-evidence
        gradient descent on (a subsample of) the training queries before
        the fit (`gp.hyperopt`, hyper_steps Adam steps on hyper_points
        rows, the evidence of hyper_objective: 'exact', 'dtc', or 'auto' =
        'exact' on this tier) and replaces the spec's Dense stds and
        diag_reg. A `gp.hyperopt.HyperoptResult` (e.g. loaded from a
        --hyper_file artifact of either package) is installed as it is,
        after checking its kernel type and feature width. Requires an
        mlp-shaped spec and features within the fp32-safe range (pass
        chunk_norm=True for packed categorical chunks). hyper_ard: learn a
        per-feature input scale too; it is applied to every encoded query
        and rides through checkpoints.

        quality='best' fills the flags still unset: chunk_norm=True,
        learn_hyper=True with hyper_ard=True, and calibrate_frac=0.1. An
        explicit learn_hyper=False is kept.

        stats / stats_dir / data_path: the schema's TableStats, or a
        directory of TableStats JSONs laid out in the schema's table order,
        or else the schema's raw CSVs under data_path (`data/loaders.py`
        SCHEMAS, PK/FK codes shared through `featurize/schema.py`).

        calibrate_frac: hold out this seeded fraction of the training
        queries and calibrate uncertainty on them after the fit (std
        temperature + split-conformal scores), as `calibrate_uncertainty`
        would on held-out lines.

        predict_cache_size: capacity of the cross-call prediction memo
        (query line -> raw mean/std); 0 keeps only within-batch dedup."""
        (chunk_norm, learn_hyper, hyper_ard, nystrom_moments,
         calibrate_frac) = self.resolve_quality_flags(
            quality, chunk_norm=chunk_norm, learn_hyper=learn_hyper,
            hyper_ard=hyper_ard, nystrom_m=nystrom_m,
            nystrom_moments=nystrom_moments, dtype=dtype,
            calibrate_frac=calibrate_frac)
        if pad_slots is not None and (nystrom_m is not None
                                      or mesh is not None
                                      or kernel_type != "nngp"):
            raise ValueError(
                "pad_slots is the single-chip exact-nngp shape-stability "
                "feature; the Nystrom tier is already shape-stable and the "
                "distributed tier pads internally")
        self.pad_slots = int(pad_slots) if pad_slots is not None else None
        if tier not in (None, "auto", "exact", "nystrom", "distributed"):
            raise ValueError("tier must be 'auto', 'exact', 'nystrom' or "
                             f"'distributed'; got {tier!r}")
        if nystrom_moments not in (None, "fp32", "df64"):
            raise ValueError("nystrom_moments must be 'fp32' or 'df64', got "
                             f"{nystrom_moments!r}")
        if kernel_type not in ("nngp", "ntk"):
            raise ValueError(
                f"kernel_type must be 'nngp' or 'ntk', got {kernel_type!r}")
        calibrate_frac = float(calibrate_frac or 0.0)
        if not 0.0 <= calibrate_frac < 1.0:
            raise ValueError(
                f"calibrate_frac must be in [0, 1), got {calibrate_frac}")
        self.device = resolve_device(device)
        check_mesh_device(mesh, self.device)
        if dist_block_size is not None and mesh is None:
            raise ValueError("dist_block_size is the distributed tier's "
                             "panel width; it needs mesh=")
        self.mesh = mesh
        self.dist_block_size = dist_block_size
        self.quality = quality
        self.schema_name = schema_name
        self.chunk_size = chunk_size
        self.predict_cache_size = int(predict_cache_size)
        self.kernel_type = kernel_type
        self.diag_reg = diag_reg
        self.dtype = np.dtype(dtype).type
        self.chunk_norm = bool(chunk_norm)
        self.nystrom_m = nystrom_m
        self._moments_unset = nystrom_moments is None
        self.nystrom_moments = nystrom_moments or "fp32"
        self.spec = spec if spec is not None else reference_kernel()
        if stats is None:
            if stats_dir is not None:
                stats = schema_stats(schema_name, stats_dir)
            else:
                stats = schema_stats_from_csvs(schema_name, data_path,
                                               chunk_size)
        self.stats = list(stats)
        self._init_encoders()

        queries, cards, _infos = self.encoder.load_queries(
            train_query_path, use_aux=use_aux,
            q_error_threshold=q_error_threshold,
            coef_var_threshold=coef_var_threshold)
        x, y = self.encoder.transform_to_arrays(queries, cards,
                                                dtype=self.dtype)
        if verbose:
            print(f"training queries: {x.shape[0]}  feature dim: {x.shape[1]}")
        # the holdout is capped at half the rows so tiny train sets under
        # quality='best' keep at least half for the fit
        n_cal = 0
        if calibrate_frac > 0.0 and x.shape[0] >= 20:
            n_cal = min(max(10, int(round(calibrate_frac * x.shape[0]))),
                        x.shape[0] // 2)
        self._auto_nystrom_m = None     # set while 'auto' may re-route
        if tier is not None:
            self._route_tier(tier, x.shape[0] - n_cal, auto_nystrom_m,
                             exact_max_n, verbose)
        self.std_scale = 1.0            # post-hoc std recalibration (MLE)
        self._conformal_scores = None   # sorted |y-mu|/std calibration set
        self.drift_monitor = None       # created lazily by record_feedback
        self.feature_scale = None       # a learned ARD scale
        self.hyper_result = None        # the HyperoptResult in effect
        x_cal = y_cal = None
        if n_cal > 0:
            # seeded holdout before the fit: calibration rows must be held
            # out or the coverage guarantee is void
            perm = np.random.default_rng(calibrate_seed).permutation(
                x.shape[0])
            cal_idx, fit_idx = perm[:n_cal], perm[n_cal:]
            x_cal, y_cal = x[cal_idx], y[cal_idx]
            x, y = x[fit_idx], y[fit_idx]
            if verbose:
                print(f"calibration holdout: {n_cal} queries "
                      f"(fit on {x.shape[0]})")
        relearn = None
        if learn_hyper:
            if isinstance(learn_hyper, bool):
                def relearn():
                    self._learn_hyperparams(x, y, hyper_steps, hyper_points,
                                            verbose, ard=bool(hyper_ard),
                                            objective=hyper_objective)
                relearn()
                if hyper_objective != "auto":
                    relearn = None      # the caller chose the objective
            else:
                if hyper_ard and learn_hyper.feature_scale is None:
                    raise ValueError(
                        "hyper_ard=True but the hyper artifact is scalar-"
                        "mode (no feature_scale) — relearn it with ard=True "
                        "or drop hyper_ard")
                self._apply_hyper_result(learn_hyper, x, verbose)
        elif hyper_ard:
            raise ValueError("hyper_ard requires learn_hyper=True")
        self.posterior = self._fit_routed(x, y, relearn, verbose)
        self._validate_fit()
        if x_cal is not None:
            self._calibrate_arrays(self._apply_feature_scale(x_cal),
                                   np.asarray(y_cal, np.float64).ravel(),
                                   verbose, source="holdout")

    @staticmethod
    def resolve_quality_flags(quality, *, chunk_norm, learn_hyper, hyper_ard,
                              nystrom_m, nystrom_moments, dtype,
                              calibrate_frac):
        """quality='best' routing into concrete flag values: the same
        decision table as the JAX package (BASELINE.md), filling only flags
        still at their unset None sentinel. learn_hyper's sentinel is None
        here, so an explicit False is kept. Returns (chunk_norm,
        learn_hyper, hyper_ard, nystrom_moments, calibrate_frac) with None
        sentinels preserved."""
        if quality not in ("reference", "best"):
            raise ValueError(
                f"quality must be 'reference' or 'best', got {quality!r}")
        if quality == "best":
            if chunk_norm is None:
                chunk_norm = True
            if learn_hyper is None:
                learn_hyper = True
            if hyper_ard is None:
                # respect a scalar hyper artifact if one was passed
                hyper_ard = (learn_hyper is True
                             or getattr(learn_hyper, "feature_scale", None)
                             is not None)
            if (nystrom_moments is None and nystrom_m is not None
                    and np.dtype(dtype) == np.float32):
                nystrom_moments = "df64"
            if calibrate_frac is None:
                calibrate_frac = 0.1
        return (chunk_norm, learn_hyper, hyper_ard, nystrom_moments,
                calibrate_frac)

    def _route_tier(self, tier: str, n: int, auto_m: int, exact_max_n,
                    verbose: bool):
        """Resolve tier='auto'/'exact'/'nystrom'/'distributed' into
        nystrom_m (None for the exact tiers) before the fit. 'auto': the
        exact tier (the distributed one with a mesh) while n <=
        exact_max_n, then the distributed tier with a mesh, the Nystrom
        tier beyond (or when an fp32 exact factor fails: `_fit_routed`)."""
        if exact_max_n is None:
            exact_max_n = default_exact_max_n(self.device, self.dtype,
                                              self.kernel_type)
        auto = tier == "auto"
        if auto:
            if self.nystrom_m is not None:
                tier = "nystrom"
            elif self.mesh is not None:
                tier = "distributed"
            else:
                tier = "exact" if n <= exact_max_n else "nystrom"
        if tier == "exact":
            if self.mesh is not None:
                raise ValueError(
                    "tier='exact' is the single-device tier; drop mesh= or "
                    "use tier='distributed'")
            self.nystrom_m = None
            if auto and np.dtype(self.dtype) == np.float32:
                # an fp32 factor that fails re-routes (_fit_routed)
                self._auto_nystrom_m = min(int(auto_m), n)
        elif tier == "distributed":
            if self.mesh is None:
                raise ValueError("tier='distributed' requires mesh=")
            self.nystrom_m = None
        else:
            if self.pad_slots is not None:
                raise ValueError(
                    "pad_slots is the single-chip exact-tier feature but "
                    f"the routed tier for n={n} is the Nystrom tier")
            self._use_nystrom(min(int(auto_m), n))
        if verbose:
            print(f"tier routing: n={n} -> {tier}"
                  + (f" (m={self.nystrom_m}, moments="
                     f"{self.nystrom_moments})" if tier == "nystrom" else "")
                  + f"; exact_max_n {exact_max_n}")

    def _use_nystrom(self, m: int):
        """Serve on the Nystrom tier with m inducing rows (unless nystrom_m
        was given), moments 'df64' under quality='best' in fp32."""
        if self.nystrom_m is None:
            self.nystrom_m = m
        if (self.quality == "best" and self._moments_unset
                and np.dtype(self.dtype) == np.float32):
            # the decision table's rule, which the constructor could not
            # apply before the tier was known
            self.nystrom_moments = "df64"

    def _fit_routed(self, x, y, relearn, verbose: bool):
        """The constructor's fit of the raw-unit rows x. Where tier='auto'
        chose the exact tier in fp32 and its factor fails, the fit goes to
        the Nystrom tier 'auto' takes beyond exact_max_n, after relearn()
        (hyperparameters learned against the exact evidence are learned
        again against the DTC evidence; None keeps them). The failed fit's
        n x n tensors are freed before it raises."""
        try:
            return self._fit(self._apply_feature_scale(x), y)
        except FactorError as err:
            if self._auto_nystrom_m is None or self.pad_slots is not None:
                raise
            reason = str(err)
        self._use_nystrom(self._auto_nystrom_m)
        self._auto_nystrom_m = None
        line = (f"tier routing: n={x.shape[0]} exact -> nystrom (m="
                f"{self.nystrom_m}, moments={self.nystrom_moments}) because "
                f"{reason}")
        if verbose:
            print(line)
        warnings.warn(line, RuntimeWarning, stacklevel=3)
        if relearn is not None:
            relearn()
        return self._fit(self._apply_feature_scale(x), y)

    def _init_encoders(self):
        """The Python encoder (training files, fall-back) and, when g++
        can build it, the native line encoder for the serving hot path.
        `encoder_kind` says which one encodes query lines."""
        from nngp_tpu_torch.native import FastEncoder, is_available

        self.encoder = MultiJoinEncoder(self.stats, chunk_norm=self.chunk_norm)
        if is_available():
            self._fast = FastEncoder(self.stats)
            self.encoder_kind = "native"
        else:
            self._fast = None
            self.encoder_kind = "python"
            print("Estimator: the native query encoder is unavailable (no "
                  "g++?); encoding query lines with the Python encoder",
                  file=sys.stderr)

    def _require_mlp_spec(self, op_name: str):
        """Hyperopt parameterizes mlp-shaped stacks only: learning a
        different kernel family than the server's would swap the model out
        from under the user. Returns (acts, denses)."""
        acts = [l for l in self.spec.layers if isinstance(l, Activation)]
        denses = [l for l in self.spec.layers if isinstance(l, Dense)]
        if not acts or len(denses) != len(acts) + 1 or len(
                {a.name for a in acts}) != 1:
            raise ValueError(
                f"{op_name} requires an mlp-shaped spec "
                "((Dense, Activation)*depth + Dense, one activation); got "
                f"{self.spec.layers}")
        return acts, denses

    def _print_hyper(self, verb: str, res):
        print(f"{verb} hyperparameters: w0={res.w0:.4f} w={res.w:.4f} "
              f"b={res.b:.4f} diag_reg={res.diag_reg:.3e} "
              f"({res.objective} log evidence {res.log_evidence:.2f} "
              f"on {res.num_points} rows)")

    def _learn_hyperparams(self, x, y, steps, max_points, verbose,
                           ard: bool = False, objective: str = "auto"):
        """Replace the spec and diag_reg (and, with ard, the feature
        scale) by evidence-learned values. save() already writes the
        learned Dense stds and the feature scale."""
        from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams

        acts, denses = self._require_mlp_spec("learn_hyper")
        max_abs = float(np.max(np.abs(x))) if x.size else 0.0
        if max_abs > _EXTEND_MAX_SCALED_ABS:
            raise ValueError(
                f"learn_hyper: max|feature| = {max_abs:.3g} exceeds the "
                "fp32-safe range (squared Gram entries overflow); pass "
                "chunk_norm=True to put packed categorical chunks on the "
                "[0, 1000] scale")
        if objective == "auto":
            objective = "dtc" if self.nystrom_m else "exact"
        if not max_points and objective != "dtc":
            raise ValueError(
                "hyper_points=0 (full-n hyperopt) requires the DTC "
                "objective — the exact loss is O(n^3) per step")
        res = fit_kernel_hyperparams(
            x, y, depth=len(acts), activation=acts[0].name,
            get=self.kernel_type, steps=steps,
            max_points=max_points or None,   # 0 -> full n (dtc is O(n m^2))
            width=denses[0].width, ard=ard, objective=objective,
            dtc_m=self._dtc_m(objective), device=self.device,
            mesh=self.mesh if objective == "dtc" else None)
        if res.feature_scale is not None:
            self.feature_scale = np.asarray(res.feature_scale, np.float64)
        if verbose:
            self._print_hyper("learned", res)
        self.spec = res.spec
        self.diag_reg = res.diag_reg
        self.hyper_result = res

    def _dtc_m(self, objective: str) -> int:
        """Inducing rows of the DTC objective: the tier's, at most 512."""
        if objective == "dtc" and self.nystrom_m:
            return min(512, self.nystrom_m)
        return 512

    def _apply_hyper_result(self, res, x: np.ndarray, verbose: bool):
        """Install an already-learned HyperoptResult (e.g. a --hyper_file
        artifact) as this server's spec, ridge and ARD scale, after
        checking its provenance (kernel type, feature width) and the fp32
        magnitude range: a mismatched artifact degrades every prediction
        with no other diagnostic."""
        num_features = x.shape[1]
        for art_features in (getattr(res, "num_features", None),
                             (len(np.ravel(res.feature_scale))
                              if res.feature_scale is not None else None)):
            if art_features is not None and art_features != num_features:
                raise ValueError(
                    f"hyper artifact was learned on {art_features} "
                    f"features but this schema encodes {num_features} — "
                    "wrong workload/stats?")
        if getattr(res, "get", None) and res.get != self.kernel_type:
            raise ValueError(
                f"hyper artifact maximized the {res.get!r} evidence but "
                f"this server fits kernel_type={self.kernel_type!r} — "
                "relearn with the matching get")
        # b != 0 turns the input prescale off (the spec is no longer scale
        # equivariant), so raw 2^64-packed chunks would overflow the
        # squared fp32 Gram
        scaled_max = float(np.max(np.abs(x))) if x.size else 0.0
        if res.feature_scale is not None:
            scaled_max *= float(np.max(np.abs(res.feature_scale)))
        if (self.dtype == np.float32 and res.b != 0.0
                and scaled_max > _EXTEND_MAX_SCALED_ABS):
            raise ValueError(
                f"hyper artifact has b={res.b:g} (prescale off) but "
                f"max|feature| ~ {scaled_max:.3g} exceeds the fp32-safe "
                "range; pass chunk_norm=True (or use fp64)")
        if res.feature_scale is not None:
            self.feature_scale = np.asarray(res.feature_scale, np.float64)
        if verbose:
            self._print_hyper("loaded", res)
        self.spec = res.spec
        self.diag_reg = res.diag_reg
        self.hyper_result = res

    @collective
    def relearn_hyperparams(self, labeled_lines: Optional[Sequence[str]] =
                            None, steps: int = 40,
                            max_points: Optional[int] = 2048,
                            verbose: bool = True) -> float:
        """Warm hyperparameter recalibration of a live server: relearn
        (w0, w, b, diag_reg), and the ARD scale if one is active,
        warm-started from the current values (one restart, `steps` Adam
        steps), then refit the posterior with the new kernel. Online
        extends shift the training distribution and the evidence optimum
        moves with it.

        labeled_lines: `query@...@card` lines to learn from and refit on;
        None takes the posterior's own training rows (exact tier only: the
        Nystrom tier does not keep its rows, so pass the full current
        training log). The objective is the serving tier's evidence.

        Transactional: on any exception during the refit, the previous
        spec, ridge, feature scale and posterior all stay in effect.
        Returns the new log evidence."""
        from nngp_tpu_torch.gp.hyperopt import fit_kernel_hyperparams

        if labeled_lines is not None:
            x_fs, cards = self._encode_labeled_lines(labeled_lines,
                                                     "relearn_hyperparams")
            y = np.log2(cards).reshape(-1, 1).astype(self.dtype)
        else:
            p = self.posterior
            if isinstance(p, NystromPosterior):
                raise ValueError(
                    "relearn_hyperparams: the streaming Nystrom tier does "
                    "not retain its training rows (O(m^2) state) — pass "
                    "labeled_lines (e.g. the serving feedback log)")
            if isinstance(p, DistributedPosterior):   # real rows, gathered
                x_tr, y_tr = p.x_natural(), p.y_natural()
            else:
                p = p.strip_padding()         # the real rows
                x_tr, y_tr = p.x_train, p.y_train
            x_fs = x_tr.cpu().numpy() * float(p.input_scale)
            y = y_tr.cpu().numpy()
        # back to raw feature units: the relearn may produce a new scale
        x_raw = (x_fs / self.feature_scale.astype(x_fs.dtype)
                 if self.feature_scale is not None else x_fs)
        acts, denses = self._require_mlp_spec("relearn_hyperparams")
        # warm init from the live spec; b is log-parameterized, so a pinned
        # zero bias warm-starts at the default 0.1
        w0 = denses[0].w_std
        w = denses[1].w_std if len(denses) > 1 else denses[0].w_std
        b = denses[0].b_std if denses[0].b_std > 0 else 0.1
        objective = "dtc" if self.nystrom_m else "exact"
        res = fit_kernel_hyperparams(
            x_raw, y, depth=len(acts), activation=acts[0].name,
            get=self.kernel_type, steps=steps, max_points=max_points,
            width=denses[0].width, init=(w0, w, b, self.diag_reg),
            reg_restarts=(), ard=self.feature_scale is not None,
            init_feature_scale=self.feature_scale, objective=objective,
            dtc_m=self._dtc_m(objective), device=self.device,
            mesh=self.mesh if objective == "dtc" else None)
        if verbose:
            self._print_hyper("relearned", res)
        old = (self.spec, self.diag_reg, self.feature_scale, self.posterior)
        try:
            self.spec = res.spec
            self.diag_reg = res.diag_reg
            if res.feature_scale is not None:
                self.feature_scale = np.asarray(res.feature_scale,
                                                np.float64)
            self.posterior = self._fit(self._apply_feature_scale(x_raw), y)
            self._validate_fit()
            self.hyper_result = res
        except BaseException:
            # a new spec, ridge or scale left in place against the old
            # posterior would put every later query in the wrong geometry
            (self.spec, self.diag_reg,
             self.feature_scale, self.posterior) = old
            raise
        return float(res.log_evidence)

    def _fit(self, x, y):
        # x/y are host numpy: the fp32 prescale probe (max|x|) is free there
        if self.nystrom_m is not None:
            return fit_nystrom(self.spec, x, y, num_inducing=self.nystrom_m,
                               diag_reg=self.diag_reg, get=self.kernel_type,
                               moments=self.nystrom_moments, mesh=self.mesh,
                               device=self.device)
        if self.mesh is not None:
            # any n: the layout pads to its quantum with inert rows
            return distributed_fit(self.spec, x, y, self.mesh,
                                   diag_reg=self.diag_reg,
                                   get=self.kernel_type,
                                   block_size=self.dist_block_size)
        pad_to = (x.shape[0] + self.pad_slots
                  if self.pad_slots is not None else None)
        return fit_gp(self.spec, x, y, diag_reg=self.diag_reg,
                      get=self.kernel_type, pad_to=pad_to,
                      device=self.device)

    def _validate_fit(self):
        """Fail loudly if the fit degenerated: non-finite alpha or factor
        diagonal, or on the Nystrom tier non-finite whitened weights or
        inverse factor (one device sync)."""
        p = self.posterior
        if isinstance(p, NystromPosterior):
            ok = torch.stack([torch.isfinite(p.beta_w).all(),
                              torch.isfinite(p.ic).all()]).cpu()
            if not (bool(ok[0]) and bool(ok[1])):
                raise FloatingPointError(
                    "Nystrom fit produced non-finite state (beta finite: "
                    f"{bool(ok[0])}, ic finite: {bool(ok[1])}). Check "
                    "training cards > 0 and feature encodings.")
            return
        if isinstance(p, DistributedPosterior):
            # pivots at l[s, g2e[s]]; every rank gets the same verdict
            if not p.is_finite():
                raise FloatingPointError(
                    "distributed GP fit produced a non-finite alpha or "
                    "factor pivot. Check training cards > 0 and feature "
                    "encodings.")
            return
        ok = torch.stack([torch.isfinite(p.alpha).all(),
                          torch.isfinite(p.l.diagonal()).all()]).cpu()
        ok_alpha, ok_l = bool(ok[0]), bool(ok[1])
        if not (ok_alpha and ok_l):
            raise FloatingPointError(
                "GP fit produced non-finite factors (alpha finite: "
                f"{ok_alpha}, chol diag finite: {ok_l}). Check training "
                "cards > 0 and feature encodings.")

    # ------------------------------------------------------- checkpoints
    @classmethod
    def restore(cls, ckpt_dir: str, spec: Optional[KernelSpec] = None,
                mesh=None, *, device):
        """An Estimator from a checkpoint directory (`meta.json` +
        `posterior.npz`) written by this package or by the JAX package
        (single-chip exact, Nystrom or distributed tier), on `device`. A
        column-block factor stays blocks above `dense_exact_max_n` and is
        assembled into one dense factor below it. A
        padded posterior (meta n_real) stays padded and extends into its
        remaining slots; pad_slots itself is construction-time
        configuration and is not restored, as in the JAX package. A
        Nystrom posterior's solve stage runs where finalize='auto' puts it
        on `device`.

        mesh: required for a distributed checkpoint, whose storage order
        is a function of the fit's mesh size: a mesh of another size, or
        a layout that does not tile it, raises. Collective then. On a
        Nystrom checkpoint the mesh is reattached for extends; a
        single-device exact checkpoint refuses one."""
        with open(os.path.join(ckpt_dir, "meta.json")) as f:
            meta = json.load(f)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.schema_name = meta["schema_name"]
        self.chunk_size = meta["chunk_size"]
        self.quality = meta.get("quality", "reference")
        self.kernel_type = meta["kernel_type"]
        self.diag_reg = meta["diag_reg"]
        self.dtype = np.dtype(meta["dtype"]).type
        if spec is not None:
            self.spec = spec
        elif "spec" in meta:
            self.spec = _spec_from_json(meta["spec"])
        else:
            self.spec = reference_kernel()
        self.stats = [TableStats.from_json(s) for s in meta["stats"]]
        self.chunk_norm = bool(meta.get("chunk_norm", False))
        self.feature_scale = (np.asarray(meta["feature_scale"], np.float64)
                              if "feature_scale" in meta else None)
        self.std_scale = float(meta.get("std_scale", 1.0))
        self.drift_monitor = None
        self.hyper_result = None
        self.pad_slots = None
        self._init_encoders()
        self.nystrom_m, self.nystrom_moments = None, "fp32"
        self.mesh, self.dist_block_size = None, None
        check_mesh_device(mesh, self.device)
        with np.load(os.path.join(ckpt_dir, "posterior.npz")) as arrs:
            self._conformal_scores = (np.asarray(arrs["conformal_scores"])
                                      if "conformal_scores" in arrs
                                      else None)
            if "nystrom" in meta:
                post = nystrom_from_numpy(
                    arrs, meta["nystrom"], self.spec, self.kernel_type,
                    self.diag_reg, self.device,
                    finalize=_resolve_finalize("auto", self.device))
                post.mesh = self.mesh = mesh
                self.posterior = post
                self.nystrom_m = post.num_inducing
                self.nystrom_moments = post.moments
                return self
            if "distributed" in meta:
                if mesh is None:
                    raise ValueError(
                        "the checkpoint holds a distributed (row-sharded) "
                        "posterior; pass mesh= to restore it over a mesh")
                d = meta["distributed"]
                saved_p = int(d.get("mesh_size", 0))
                if saved_p and int(mesh.size()) != saved_p:
                    # the block-cyclic storage order is a function of the
                    # fit's mesh size: another p would mispermute every row
                    raise ValueError(
                        f"checkpoint was fit on a {saved_p}-device mesh; "
                        f"the restore mesh has {int(mesh.size())}")
                n = int(arrs["l"].shape[0])
                self.posterior = distributed_from_numpy(
                    arrs, self.spec, self.kernel_type, mesh,
                    block_size=int(d["block_size"]),
                    n_real=int(d.get("n_real", n)),
                    input_scale=float(d.get("input_scale", 1.0)),
                    axis_name=d.get("axis_name", "data"))
                self.mesh = mesh
                self.dist_block_size = int(d["block_size"])
                return self
            if mesh is not None:
                raise ValueError(
                    "the checkpoint holds a single-device posterior but "
                    "mesh= was passed; refit with Estimator(mesh=...) for a "
                    "row-sharded model, or restore without mesh")
            state = {
                "x_train": arrs["x_train"], "y_train": arrs["y_train"],
                "l": _checkpoint_factor(meta, arrs, self.device,
                                        self.kernel_type),
                "alpha": arrs["alpha"], "reg": arrs["reg"],
                "k_tt_nngp": (arrs["k_tt_nngp"] if "k_tt_nngp" in arrs
                              else None),
                "diag_reg": self.diag_reg,
                "input_scale": float(meta.get("input_scale", 1.0)),
                "n_real": (int(meta["n_real"]) if "n_real" in meta
                           else None),
            }
        self.posterior = posterior_from_numpy(state, self.spec,
                                              self.kernel_type, self.device)
        return self

    @collective
    def save(self, ckpt_dir: str):
        """Persist the posterior, the encoder stats and the calibration:
        the JAX package's single-chip, Nystrom or distributed checkpoint
        format. With a mesh it is collective: a distributed posterior's
        shards are gathered into rank 0's host memory, rank 0 writes, and
        the ranks meet at a barrier before returning."""
        p = self.posterior
        meta = {
            "schema_name": self.schema_name,
            "chunk_size": self.chunk_size,
            "kernel_type": self.kernel_type,
            "diag_reg": self.diag_reg,
            "dtype": np.dtype(self.dtype).name,
            "spec": _spec_to_json(self.spec),
            "stats": [s.to_json() for s in self.stats],
            "chunk_norm": self.chunk_norm,
            "quality": self.quality,
        }
        if self.feature_scale is not None:
            meta["feature_scale"] = [float(v) for v in self.feature_scale]
        if self.std_scale != 1.0:
            meta["std_scale"] = float(self.std_scale)
        if isinstance(p, NystromPosterior):
            arrs, meta["nystrom"] = nystrom_to_numpy(p)
        elif isinstance(p, DistributedPosterior):
            arrs, meta["distributed"] = distributed_to_numpy(p)
        else:
            # x_train is stored divided by input_scale; the scale must ride
            # along or a restored posterior would mis-scale every query
            meta["input_scale"] = float(p.input_scale)
            if p.n_real is not None:
                # padded: without the real-row count a restore would take
                # the inert rows for training data
                meta["n_real"] = int(p.n_real)
            state = posterior_to_numpy(p)
            arrs = {k: state[k] for k in ("x_train", "y_train", "alpha",
                                          "reg")}
            l = state["l"]
            if isinstance(l, BlockLowerTriangular):
                # the JAX package's keys; no dense n x n is assembled
                meta["l_block_starts"] = list(l.starts)
                for i, blk in enumerate(l.blocks):
                    arrs[f"l_block_{i}"] = blk
            else:
                arrs["l"] = l
            if state["k_tt_nngp"] is not None:
                arrs["k_tt_nngp"] = state["k_tt_nngp"]
        if is_lead(self.mesh):    # a distributed gather is rank 0's only
            if self._conformal_scores is not None:
                arrs["conformal_scores"] = np.asarray(self._conformal_scores)
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
                json.dump(meta, f)
            np.savez(os.path.join(ckpt_dir, "posterior.npz"), **arrs)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.get_group())

    # --------------------------------------------------------- warm-up
    @collective
    def load_model(self, verbose: bool = True):
        """Warm-up prediction on the training rows (the reference
        estimator's `load_model`), through the serving buckets; on the
        Nystrom tier on the inducing rows."""
        p = self.posterior
        if isinstance(p, NystromPosterior):
            rows = p.x_m
        elif isinstance(p, DistributedPosterior):
            rows = p.x_natural()      # every rank predicts the same rows
        else:
            rows = p.x_train[:p.num_train]
        mean, std = self._bucketed_predict(
            (rows * p.input_scale).cpu().numpy())
        if verbose:
            print(mean.shape, std.shape)
            print("Model construction complete.")

    @collective
    def warmup(self, max_batch: int = 4096, verbose: bool = True) -> list:
        """Run every serving bucket up to `max_batch` once, so that the
        first request of each size pays neither the kernel library's build
        and load nor the bucket's CUDA graph capture. Synthetic rows go
        straight through `_bucketed_predict`: the prediction memo, the
        drift monitor and the posterior are untouched. Returns the bucket
        sizes warmed (up to the largest bucket; a larger batch runs in
        chunks of it)."""
        graphs = self._bucket_graphs()
        largest = graphs.largest if graphs is not None else max_batch
        buckets = buckets_upto(max_batch, largest)
        for b in buckets:
            t0 = time.perf_counter()
            # the serving dtype: ones, not zeros (a zero row has zero norm,
            # the acos(rho) edge instead of the serving path)
            self._bucketed_predict(np.ones((b, self._feature_dim()),
                                           dtype=self.dtype))
            if verbose:
                print(f"warmup: bucket {b} ready "
                      f"({time.perf_counter() - t0:.3f} s)")
        return buckets

    def _bucket_graphs(self):
        """The serving buckets of the current posterior (None on the
        distributed tier, which predicts eagerly), made at first use."""
        p = self.posterior
        if isinstance(p, DistributedPosterior):
            return None
        graphs = self._graphs
        if graphs is None or graphs.post is not p:
            graphs = self._graphs = BucketGraphs(p, self._serve_lock)
        return graphs

    def _bucketed_predict(self, x: np.ndarray):
        """(mean, std) as 1-D numpy arrays of encoded rows x: the one place
        the serving bucket policy lives (`serve/graphs.py`). On the card
        the exact and Nystrom tiers replay each bucket's CUDA graph; the
        distributed tier predicts eagerly in chunks."""
        with self._serve_lock:
            graphs = self._bucket_graphs()
            if graphs is None:
                return self.posterior.predict_mean_std_chunked(x)
            return graphs.predict(x)

    def _feature_dim(self) -> int:
        """The encoded feature width, whatever the tier (exact: x_train;
        Nystrom: x_m; distributed: this rank's x_storage)."""
        p = self.posterior
        for name in ("x_train", "x_m", "x_storage"):
            if hasattr(p, name):
                return int(getattr(p, name).shape[1])
        raise AttributeError("posterior has none of x_train, x_m, "
                             "x_storage")

    # -------------------------------------------------------- encoding
    def _apply_chunk_norm(self, x: np.ndarray) -> np.ndarray:
        """The native encoder emits raw features; chunk_norm multiplies by
        the encoder's per-slot scale vector (cached per dtype)."""
        if self.chunk_norm:
            scale = getattr(self, "_chunk_norm_scale", None)
            if scale is None or scale.dtype != x.dtype:
                scale = self.encoder.col_scale.astype(x.dtype)
                self._chunk_norm_scale = scale
            x = x * scale
        return x

    def _apply_feature_scale(self, x: np.ndarray) -> np.ndarray:
        """ARD: a posterior fitted on x * feature_scale must see every
        encoded query scaled the same way."""
        if self.feature_scale is None:
            return x
        return x * self.feature_scale.astype(x.dtype)

    def encode_lines(self, query_lines: Sequence[str]) -> np.ndarray:
        """Encoded rows of card-less query lines (span `estimator.encode`,
        attr rows)."""
        with span("estimator.encode", rows=len(query_lines)):
            if self._fast is not None:
                x, *_ = self._fast.encode_multi("\n".join(query_lines),
                                                with_card=False,
                                                dtype=self.dtype)
                return self._apply_feature_scale(self._apply_chunk_norm(x))
            parsed = [self.encoder.parse_line_without_card(l)
                      for l in query_lines if l.strip()]
            return self._apply_feature_scale(
                self.encoder.encode_batch(parsed, dtype=self.dtype))

    def _encode_labeled_lines(self, labeled_lines, op_name: str):
        """Labeled `query@...@card` lines -> (x, cards), card >= 1
        enforced."""
        if self._fast is not None:
            x, cards, *_ = self._fast.encode_multi("\n".join(labeled_lines),
                                                   with_card=True,
                                                   dtype=self.dtype)
            x = self._apply_chunk_norm(x)
        else:
            parsed, cards = [], []
            for line in labeled_lines:
                if not line.strip():
                    continue
                tids, preds, joins, card = self.encoder.parse_line(line)
                parsed.append((tids, preds, joins))
                cards.append(card)
            x = self.encoder.encode_batch(parsed, dtype=self.dtype)
            cards = np.asarray(cards, dtype=np.float64)
        if np.any(cards < 1):
            raise ValueError(f"{op_name} requires card >= 1 on every "
                             "labeled line (log2 of 0 is -inf)")
        return self._apply_feature_scale(x), cards

    def _guard_feature_magnitude(self, x: np.ndarray, op_name: str):
        """Refuse fp32 features the posterior's input_scale does not cover
        (their squared Gram entries would overflow into a NaN factor);
        checked on host numpy, before any kernel runs."""
        scale = float(self.posterior.input_scale)
        if (x.dtype == np.float32 and x.size
                and float(np.max(np.abs(x))) / max(scale, 1.0)
                > _EXTEND_MAX_SCALED_ABS):
            raise ValueError(
                f"{op_name}: new features exceed the magnitude the "
                f"posterior was fitted for (input_scale={scale:g}); the "
                "factor cannot be rescaled in place — refit (a fresh "
                "Estimator picks a covering scale from the data)")

    # --------------------------------------------------- online learning
    def _install_posterior(self, candidate):
        """Validate BEFORE installing so a bad batch cannot corrupt a live
        server: the old posterior stays authoritative on failure."""
        old = self.posterior
        try:
            self.posterior = candidate
            self._validate_fit()
        except FloatingPointError:
            self.posterior = old
            raise

    @collective
    def extend_with_lines(self, labeled_lines: Sequence[str]) -> int:
        """Online learning: fold freshly-labeled `query@...@card` lines into
        the posterior, keeping the fit's ridge: an O(n^2 k) block-Cholesky
        append on the exact tier, a moment update on the Nystrom tier. A
        new posterior is built and installed after validation. Returns the
        number of rows added."""
        x, cards = self._encode_labeled_lines(labeled_lines,
                                              "extend_with_lines")
        self._guard_feature_magnitude(x, "extend_with_lines")
        y = np.log2(cards).reshape(-1, 1).astype(self.dtype)
        with self._serve_lock:
            post = self.posterior
            if isinstance(post, GPPosterior) and post.n_real is not None:
                # padded: the batch bucketed to a power of two (>= 64)
                # written into the slots in place, or the dense fall-back
                # when they run out
                cand = post.extend(x, y, bucket=64)
            else:
                cand = post.extend(x, y)
            if cand is post:
                # in place (validated before it wrote): the graphs read
                # the same storage (their next run captures them again if
                # the live order moved), only the memo is stale
                self._pred_cache = collections.OrderedDict()
            else:
                self._install_posterior(cand)
        return x.shape[0]

    @collective
    def forget_with_lines(self, labeled_lines: Sequence[str]) -> int:
        """Online forgetting (Nystrom tier only): remove labeled lines
        trained or extended in before (expired feedback, a sliding window)
        by exact moment subtraction, O(s m^2 + m^3). The exact tier
        refuses: its factor has no stable downdate. Transactional; returns
        the number of rows removed."""
        if not isinstance(self.posterior, NystromPosterior):
            raise NotImplementedError(
                "forget_with_lines requires the streaming Nystrom tier "
                "(Estimator(nystrom_m=...)); the exact factor has no "
                "stable downdate — refit a fresh Estimator instead")
        x, cards = self._encode_labeled_lines(labeled_lines,
                                              "forget_with_lines")
        y = np.log2(cards).reshape(-1, 1).astype(self.dtype)
        self._install_posterior(self.posterior.forget(x, y))
        return x.shape[0]

    @collective
    def grow_inducing(self, labeled_lines: Sequence[str],
                      num_new: int = 512, seed: int = 0) -> int:
        """Grow the Nystrom tier's capacity: enlarge the inducing set by
        `num_new` seeded uniform rows of `labeled_lines` and refit on
        exactly those lines (the full training log: growth changes the
        whitening basis, so it is an O(n (m + s)^2) streamed refit). The
        ELBO (`posterior.elbo()`) cannot decrease. Transactional; returns
        the new inducing count."""
        if not isinstance(self.posterior, NystromPosterior):
            raise NotImplementedError(
                "grow_inducing requires the streaming Nystrom tier "
                "(Estimator(nystrom_m=...)); the exact tier has no "
                "inducing set — its capacity is n itself")
        x, cards = self._encode_labeled_lines(labeled_lines, "grow_inducing")
        self._guard_feature_magnitude(x, "grow_inducing")
        y = np.log2(cards).reshape(-1, 1).astype(self.dtype)
        rng = np.random.default_rng(seed)
        pick = rng.choice(x.shape[0], size=min(num_new, x.shape[0]),
                          replace=False)
        self._install_posterior(self.posterior.grow_inducing(x[pick], x, y))
        self.nystrom_m = self.posterior.num_inducing
        return self.posterior.num_inducing

    # ---------------------------------------------------------- predict
    def _predict_raw(self, query_lines: Sequence[str]):
        """Batch predict returning the posterior's own std (no
        recalibration), one result per line.

        Duplicate lines are predicted once, and results persist in a
        bounded LRU memo keyed by the query text (plan enumeration
        re-submits the same sub-queries). A line served from the memo
        launches no kernel.

        Spans: `estimator.predict` (attrs: lines; memo_hits, the lines
        the memo answered; dup_hits, repeats of a line this call
        predicts; rows, the lines that reach the device) around
        `estimator.memo`, `estimator.encode`, the buckets' `graphs.run`
        and `estimator.assemble`."""
        with span("estimator.predict", lines=len(query_lines)) as sp:
            with span("estimator.memo", lines=len(query_lines)):
                # one result PER LINE is the contract: both encoders skip
                # blank lines, which would misalign every later result
                keys = []
                for i, line in enumerate(query_lines):
                    k = line.strip()
                    if not k:
                        raise ValueError(f"blank query line at index {i}")
                    keys.append(k)
                # the memo first, then the predict: a new posterior or an
                # in-place extend replaces the memo after the model
                # changes, so results computed here can only land in a memo
                # that belongs to this model or to an older (already
                # discarded) one
                cache = self._pred_cache
                missed = []
                for k in keys:
                    if k in cache:
                        cache.move_to_end(k)  # keep hot queries resident
                    else:
                        missed.append(k)
                need = list(dict.fromkeys(missed))
            sp.set(memo_hits=len(keys) - len(missed),
                   dup_hits=len(missed) - len(need), rows=len(need))
            if need:
                mean, std = self._bucketed_predict(self.encode_lines(need))
            with span("estimator.assemble", lines=len(keys)):
                fresh = dict(zip(need, zip(mean, std))) if need else {}
                pairs = [fresh[k] if k in fresh else cache[k] for k in keys]
                cap = self.predict_cache_size
                if cap > 0:
                    cache.update(fresh)
                    while len(cache) > cap:
                        cache.popitem(last=False)
                out = np.asarray(pairs, dtype=self.dtype)
                return out[:, 0].copy(), out[:, 1].copy()

    @collective
    def predict(self, query_lines: Sequence[str]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(pred_mean, pred_std) in log2-card space, one entry per line.
        std is multiplied by the scale fitted by `calibrate_uncertainty`
        (1.0 until then)."""
        mean, std = self._predict_raw(query_lines)
        if self.std_scale != 1.0:
            std = std * self.std_scale
        return mean, std

    # ------------------------------------------------------- uncertainty
    @collective
    def calibrate_uncertainty(self, labeled_lines: Sequence[str],
                              verbose: bool = True) -> float:
        """Post-hoc uncertainty calibration on HELD-OUT labeled lines: the
        MLE std scale applied to every later predict std, and the
        split-conformal score set behind `predict_interval`. Both are
        checkpointed. Returns the std scale."""
        x, cards = self._encode_labeled_lines(labeled_lines,
                                              "calibrate_uncertainty")
        return self._calibrate_arrays(x, np.log2(cards), verbose,
                                      source="held-out lines")

    def _calibrate_arrays(self, x, y, verbose: bool, source: str) -> float:
        """Shared core of `calibrate_uncertainty` and the `calibrate_frac`
        holdout, from the raw posterior std."""
        from nngp_tpu_torch.eval.calibration import conformal_scores, fit_std_scale
        mean, std = self._bucketed_predict(x)
        self.std_scale = fit_std_scale(y, mean, std)
        self._conformal_scores = conformal_scores(y, mean, std)
        if verbose:
            print(f"calibrated on {x.shape[0]} {source}: std_scale="
                  f"{self.std_scale:.4f}")
        return self.std_scale

    @collective
    def predict_interval(self, query_lines: Sequence[str],
                         alpha: float = 0.1):
        """(mean, lo, hi) in log2-card space: split-conformal central
        intervals with finite-sample >= 1-alpha coverage for exchangeable
        queries. Needs `calibrate_uncertainty` first."""
        if self._conformal_scores is None:
            raise ValueError(
                "predict_interval requires calibrate_uncertainty(labeled_"
                "lines) first (held-out lines, e.g. the feedback log)")
        from nngp_tpu_torch.eval.calibration import conformal_quantile
        qhat = conformal_quantile(self._conformal_scores, alpha)
        mean, std = self._predict_raw(query_lines)
        return mean, mean - qhat * std, mean + qhat * std

    @collective
    def record_feedback(self, labeled_lines: Sequence[str]):
        """Fold labeled serving feedback into the workload-drift monitor
        and return a `serve.drift.DriftReport`: whether the model still
        explains the live workload and, if not, the remediation measured
        to help this tier ('relearn_hyperparams' on the exact tier,
        'grow_inducing' on the Nystrom tier). Observes only; call
        `drift_monitor.reset()` after acting."""
        from nngp_tpu_torch.serve.drift import DriftMonitor, DriftReport
        if self.drift_monitor is None:
            self.drift_monitor = DriftMonitor()
        x, cards = self._encode_labeled_lines(labeled_lines,
                                              "record_feedback")
        y = np.log2(cards)
        mean, std = self._bucketed_predict(x)
        std = np.maximum(std * self.std_scale, self.drift_monitor.std_floor)
        abs_z = np.abs(y - mean) / std
        drift = self.drift_monitor.update(abs_z)
        action = None
        if drift:
            action = ("grow_inducing"
                      if isinstance(self.posterior, NystromPosterior)
                      else "relearn_hyperparams")
        q = np.exp2(np.abs(y - mean))  # symmetric q-error in card space
        return DriftReport(
            drift=drift, action=action,
            mean_abs_z=float(np.mean(abs_z)),
            median_q_error=float(np.median(q)),
            n_observed=self.drift_monitor.n,
            ph_stat=self.drift_monitor.stat,
            threshold=self.drift_monitor.threshold)
