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

Fit, dense layout (n up to `dense_exact_max_n`): `gram_sym` writes the
ridged solve Gram (exact diagonal + r fused in, both triangles written)
into the factor's own (n, n) storage, column-major, which is factored
there in place (`_factor_block_`: cuSOLVER's potrf on the card,
`ops.cusolver.potrf_lower_`; `torch.linalg.cholesky_ex` and a copy back on
the CPU), and two triangular solves on it give alpha. Predict:
`gram_cross` gives K_*t; the solves are cuBLAS trsm. Extend: `gram_cross`
gives K21 and `gram_sym` K22, and `ops.linalg.cholesky_append_rows`
appends them to the factor. A factor that fails (fit or extend) raises
`ops.linalg.FactorError`.

Fit, column-block layout (above the dense cap; the JAX package's large-n
path): the factor is an `ops.linalg.BlockLowerTriangular` of panels
_BLOCK_PANEL columns wide, factored left-looking by
`ops.linalg.fused_panel_cholesky` from panels the kernels write straight
into each block (`gram_sym` its diagonal square with the exact diagonal
and the ridge, `gram_cross` the rows below), so K + rI never exists and
the factor takes ~n^2/2 elements. The solves run in place over the blocks
and the extend appends to every block. An NTK posterior keeps no train
NNGP Gram there (`k_tt_nngp` None): its covariance applies K_tt panel by
panel (`ops.gram.panel_symm_matmul`) at each predict. Evidence and
checkpoints read the blocks.

Padded posteriors (`fit_gp(pad_to=)`, as in the JAX package): the storage
holds pad_to rows, the real ones first, then inert rows (copies of row 0,
zero label, a unit row of the factor, masked out of every cross Gram). The
fit writes the pad's unit rows into the (pad_to, pad_to) storage, then
builds, factors and solves the n real rows in its leading block, as the
dense layout does (the padded Gram's factor is block diagonal). A
predict reads the live prefix of the storage only (`live_rows`: the real
rows rounded up to LIVE_STEP), its factor block in place. `extend`
writes new rows into the pad slots in place
(`ops.linalg.padded_append_rows_`), so every tensor a predict reads keeps
its storage, and a CUDA graph captured over them stays valid until
n_real crosses a LIVE_STEP (`serve/graphs.py` captures it again). pad_to
is capped by `dense_exact_max_n`: padding is a dense-layout feature, as
in the JAX package.

Spans (`utils/profiling.py::span`, off until `profiling.enable()`): a fit
is `exact.fit` (rows, pad_to, layout 'dense' / 'padded' / 'blocks',
dtype, get) around `exact.prepare` (the input-scale probe, the copy to
the device, the exact diagonal and the ridge; probe 'given', 'skipped',
'host' or 'device'), `exact.gram` (dense and padded layouts: the Gram,
the factor's storage and its pad rows, the padding, the row mask),
`exact.factor` (the Cholesky up to its info sync, of factor_rows = n rows
in every layout, in_place True where cuSOLVER factored the storage itself;
the whole column-block factor) and `exact.solve` (alpha's two triangular
solves; padded: alpha written into its padded storage). A column-block fit
adds the counts blocks and factor_bytes (the blocks' storage) to
`exact.fit` and one `exact.block` a block, with its gram, update and
factor steps, under `exact.factor` (`ops.linalg.fused_panel_cholesky`).
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from nngp_tpu_torch.models.kernel_spec import (KernelSpec, diag_eval,
                                               is_scale_equivariant)
from nngp_tpu_torch.ops.cublas import trsm_lower, trsm_lower_t
from nngp_tpu_torch.ops.cusolver import potrf_lower_
from nngp_tpu_torch.ops.gram import panel_symm_matmul
from nngp_tpu_torch.ops.gram_cuda import gram_cross, gram_sym
from nngp_tpu_torch.ops.linalg import (BlockLowerTriangular, FactorError,
                                       block_cholesky_append_rows,
                                       block_tri_solve_lower,
                                       block_tri_solve_lower_t,
                                       cholesky_append_rows, column_blocks,
                                       fused_panel_cholesky,
                                       padded_append_rows_)
from nngp_tpu_torch.utils.device import resolve_device
from nngp_tpu_torch.utils.profiling import span


# The exact tier's memory rule: a train-set size is served exactly while
# its largest device-memory peak stays within EXACT_MEMORY_SHARE of the
# card's memory. The peaks, in bytes per element of the n x n Gram, by
# kernel and dtype: a fit, an extend (with the posterior it extends), and a
# refit while the live posterior is kept, as `relearn_hyperparams` refits.
#
# The dense layout: nngp 8.00, 8.41 and 12.00 bytes in fp32, 16.01, 16.82
# and 24.01 in fp64; an ntk posterior also keeps the train NNGP Gram, so
# it needs more; the refit's is the largest. Measured on an NVIDIA H100
# 80GB HBM3 (700 W) by `chip_smoke.py` (phase 8, which fails if a peak
# exceeds the constants below; PERF.md). nngp: ~75k rows fp32 and ~53k
# fp64 on the 80 GB card. `dense_exact_max_n` is that cap; above it the
# fit takes the column-block layout, whose peaks are
# EXACT_PEAK_BYTES_PER_N2 and `default_exact_max_n` the exact tier's cap
# under them. The extend's is the largest: two factors of ~n^2/2
# elements (the blocks' squares hold their zero upper triangles: n w / 2
# more) and its (n, m) solves: nngp fp64 at 90,000 rows 4.10, 8.27 and
# 8.19 bytes, ntk fp64 at 60,000 4.15, 8.53 and 8.43, fp32 half that
# (`chip_smoke.py` phase 16, which fails if a peak exceeds the constants;
# PERF.md §6, the same card): ~126k rows fp32 and ~90k nngp fp64.
# On the CPU the JAX package's numbers stay: the column-block layout from
# BLOCK_LAYOUT_MIN_N_CPU rows and an exact tier up to EXACT_MAX_N_CPU.
EXACT_MEMORY_SHARE = 0.8
DENSE_PEAK_BYTES_PER_N2 = {("nngp", torch.float32): 12.1,
                           ("nngp", torch.float64): 24.1,
                           ("ntk", torch.float32): 20.1,
                           ("ntk", torch.float64): 40.1}
EXACT_PEAK_BYTES_PER_N2 = {("nngp", torch.float32): 4.3,
                           ("nngp", torch.float64): 8.35,
                           ("ntk", torch.float32): 4.3,
                           ("ntk", torch.float64): 8.6}
EXACT_MAX_N_CPU = 55000
BLOCK_LAYOUT_MIN_N_CPU = 28000
# Tests set it to force the layout switch (the fit takes the column-block
# layout from this many rows); None: above `dense_exact_max_n`.
_BLOCK_LAYOUT_MIN_N = None
# Columns of a block of the column-block factor: at 90,000 rows fp64 the
# fit took 5.17-5.38 s at 2,048 against 5.40 s at 4,096, whose wider
# blocks hold ~1.3% more beside a live posterior (PERF.md §6).
_BLOCK_PANEL = 2048


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def _max_n(device, dtype, get, peaks) -> int:
    total = torch.cuda.get_device_properties(device).total_memory
    return int(math.sqrt(EXACT_MEMORY_SHARE * total
                         / peaks[get, _torch_dtype(dtype)]))


def dense_exact_max_n(device, dtype, get: str = "nngp") -> int:
    """The largest train-set size whose dense-layout peaks for kernel `get`
    stay within EXACT_MEMORY_SHARE of `device`'s memory
    (BLOCK_LAYOUT_MIN_N_CPU - 1 on the CPU): the layout switch and
    pad_to's cap. dtype: the working dtype, numpy or torch."""
    device = torch.device(device)
    if device.type != "cuda":
        return BLOCK_LAYOUT_MIN_N_CPU - 1
    return _max_n(device, dtype, get, DENSE_PEAK_BYTES_PER_N2)


def default_exact_max_n(device, dtype, get: str = "nngp") -> int:
    """The largest train-set size whose exact-tier peaks for kernel `get`
    stay within EXACT_MEMORY_SHARE of `device`'s memory, the column-block
    layout's above `dense_exact_max_n` (EXACT_MAX_N_CPU on the CPU).
    dtype: the working dtype, numpy or torch."""
    device = torch.device(device)
    if device.type != "cuda":
        return EXACT_MAX_N_CPU
    return _max_n(device, dtype, get, EXACT_PEAK_BYTES_PER_N2)


def _dense_cap(device, dtype, get) -> int:
    """The most rows a fit factors densely: dense_exact_max_n, or below
    _BLOCK_LAYOUT_MIN_N where that is set."""
    if _BLOCK_LAYOUT_MIN_N is not None:
        return _BLOCK_LAYOUT_MIN_N - 1
    return dense_exact_max_n(device, dtype, get)


def uses_block_layout(n: int, device, dtype, get: str = "nngp") -> bool:
    """Whether an exact fit of n rows keeps its factor as column blocks."""
    return n > _dense_cap(device, dtype, get)


# Columns of an fp32 factor converted to fp64 at a time by the solves of
# an fp64 right-hand side (`_tri_solve`) and rows by the products
# (`_mm_wide`)
_WIDE_BLOCK = 4096


def _tri_solve(l, b, transpose=False):
    """L^-1 b, or L^-T b with transpose=True, for a lower-triangular L: a
    dense tensor or a `BlockLowerTriangular`. A right-hand side of a wider
    dtype than L's (fp64 against an fp32 factor) is solved in its own
    dtype by block substitution, L converted a bounded slice at a time:
    no (n, n) fp64 copy. Column blocks are always solved so, in place.
    A dense L may be the leading block of a larger factor (a padded
    posterior's live prefix, `live_rows`, or its fit's real rows): on the
    card both solves read it in place (`ops.cublas.trsm_lower(_t)`), where
    `torch.linalg.solve_triangular` would copy it first."""
    if isinstance(l, torch.Tensor) and b.dtype == l.dtype:
        if l.is_cuda and not (l.is_contiguous() or l.mT.is_contiguous()):
            return (trsm_lower_t if transpose else trsm_lower)(l, b)
        if transpose:
            return torch.linalg.solve_triangular(l.mT, b, upper=True)
        return torch.linalg.solve_triangular(l, b, upper=False)
    if isinstance(l, torch.Tensor):
        l = column_blocks(l, _WIDE_BLOCK)
    if transpose:
        return block_tri_solve_lower_t(l, b)
    return block_tri_solve_lower(l, b)


def _mm_wide(a, b):
    """a @ b in b's dtype for an a of a narrower one, a's rows converted
    _WIDE_BLOCK at a time."""
    if a.dtype == b.dtype:
        return a @ b
    out = b.new_empty((a.shape[0], b.shape[1]))
    for s in range(0, a.shape[0], _WIDE_BLOCK):
        out[s:s + _WIDE_BLOCK] = a[s:s + _WIDE_BLOCK].to(b.dtype) @ b
    return out


# A padded posterior's predict reads its real rows rounded up to this many
# (`live_rows`). A serving bucket's CUDA graph fixes that order, so an
# in-place extend captures the buckets again only when n_real crosses a
# step (`serve/graphs.py`): at 64-row feedback buckets, every fourth
# extend. The step's own cost is its pad rows in the solve: 208 of the
# 11,008 that synth6's 10,800 real rows take, (11,008 / 10,800)^2 - 1 =
# 3.9% of its work.
LIVE_STEP = 256


def live_rows(post) -> int:
    """The leading storage rows an exact posterior's predict reads: for a
    padded one its real rows rounded up to LIVE_STEP, at most its storage
    (the rows beyond are inert, and the real rows' forward solve never
    reaches the unit factor rows below them); every storage row
    otherwise."""
    p = post.num_padded
    if post.n_real is None:
        return p
    return min(p, -(-post.n_real // LIVE_STEP) * LIVE_STEP)


@dataclasses.dataclass
class GPPosterior:
    """Fitted GP posterior state, all tensors on one device."""

    x_train: torch.Tensor            # (n, d), stored divided by input_scale
    y_train: torch.Tensor            # (n, 1)
    # (n, n) lower Cholesky of solve-kernel + r I: a tensor, or above
    # dense_exact_max_n a BlockLowerTriangular
    l: object
    alpha: torch.Tensor              # (n, 1) (solve-kernel + r I)^-1 Y
    reg: torch.Tensor                # scalar ridge actually added
    # (n, n) train NNGP Gram of a get='ntk' posterior with a dense factor;
    # None for nngp and for a column-block factor (`_ktt_matmul`)
    k_tt_nngp: Optional[torch.Tensor]
    spec: KernelSpec
    get: str = "nngp"
    diag_reg: float = 1e-3
    # Power-of-two input prescale (fp32 overflow guard): x_train is stored
    # divided by it and every incoming x is divided on entry. For
    # scale-equivariant specs the Grams scale by exactly scale^-2, so the
    # mean is invariant and std/cov are multiplied back on exit.
    input_scale: float = 1.0
    # A padded posterior (`fit_gp(pad_to=)`): the count of real leading
    # rows, and on the device their (N,) 1/0 mask, which every cross Gram
    # is multiplied by; both None for an exact-shape posterior. `extend`
    # advances both in place.
    n_real: Optional[int] = None
    row_mask: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.x_train.device

    @property
    def num_train(self) -> int:
        """The real training rows (the storage's on an exact-shape
        posterior)."""
        return self.x_train.shape[0] if self.n_real is None else self.n_real

    @property
    def num_padded(self) -> int:
        """Storage rows, inert pad rows included."""
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

    def _ktt_matmul(self, w):
        """K_tt @ w for the NTK covariance, in w's dtype: from the resident
        train NNGP Gram, or panel by panel when the posterior keeps none
        (`ops.gram.panel_symm_matmul`)."""
        if self.k_tt_nngp is not None:
            return _mm_wide(self.k_tt_nngp, w)
        return panel_symm_matmul(self.spec, self.x_train, w, "nngp")

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
        keeps the prescaled fp32 cross Gram.

        A padded posterior reads the live prefix of its storage
        (`live_rows`): the cross Gram against x_train[:k], the mean against
        alpha[:k], the solve against the leading (k, k) block of its
        factor, read in place. Its rows from n_real to k are inert pad rows,
        masked out as before. Any other posterior reads all of it."""
        x_raw = self._as_input(x_test)
        x_test = x_raw
        if self.input_scale != 1.0:
            x_test = x_raw * (1.0 / self.input_scale)
        layers, spec, dtype = self.spec.layers, self.spec, self.x_train.dtype
        wide = self._raw64
        k = live_rows(self)
        x_train, l, alpha, mask = self.x_train, self.l, self.alpha, \
            self.row_mask
        if k < self.num_padded:
            x_train, l, alpha = x_train[:k], l[:k, :k], alpha[:k]
        if mask is not None:
            mask = None if k == self.n_real else mask[:k]

        def var_kernels(fn):
            if wide:
                return raw_fp64(fn, x_raw, x_train, self.input_scale)
            return fn(x_test, x_train)

        def k_diag(xs, _):
            return diag_eval(layers, xs, "nngp")

        def k_ss(xs, _):
            return gram_sym(spec, xs, "nngp")           # exact diagonal

        def masked(cross):
            # inert pad rows give finite kernel values: zeroed, the unit
            # factor rows and zero alpha rows see the dense system
            return cross if mask is None else cross * mask.to(cross.dtype)

        if self.get == "nngp":
            cross = masked(gram_cross(spec, x_test, x_train, "nngp"))
            mean = cross @ alpha                         # (m, 1)
            if compute_cov is False:
                return mean
            if wide:
                cross = masked(var_kernels(
                    lambda a, b: gram_cross(spec, a, b, "nngp")))
            v = _tri_solve(l, cross.mT)  # (k, m)
            if compute_cov == "diag":
                var = var_kernels(k_diag) - torch.sum(v * v, dim=0)
                return mean, torch.clamp_min(var, 0.0).to(dtype)
            return mean, (var_kernels(k_ss) - v.mT @ v).to(dtype)

        pair = ("nngp", "ntk")
        nngp_cross, ntk_cross = gram_cross(spec, x_test, x_train, pair)
        mean = ntk_cross @ alpha
        if compute_cov is False:
            return mean
        if wide:
            nngp_cross, ntk_cross = var_kernels(
                lambda a, b: gram_cross(spec, a, b, pair))
        # w = (T + rI)^-1 T_t* via two triangular solves, shape (n, m)
        w = _tri_solve(l, _tri_solve(l, ntk_cross.mT), transpose=True)
        kw = self._ktt_matmul(w)                     # K_tt T^-1 T_t*, (n, m)
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
        gains n log scale^2 and the quadratic term is divided by scale^2.
        Pad rows add nothing: their label and alpha are zero, their factor
        diagonal one; n counts the real rows. A column-block factor gives
        its diagonal block by block."""
        n = self.num_train
        quad = float(torch.sum(self.y_train * self.alpha))
        logdet = float(2.0 * torch.sum(torch.log(self.l.diagonal())))
        if self.input_scale != 1.0:
            s2 = float(self.input_scale) ** 2
            quad /= s2
            logdet += n * math.log(s2)
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    # --------------------------------------------------------------- extend
    def extend(self, x_new, y_new, bucket: Optional[int] = None
               ) -> "GPPosterior":
        """m labeled rows appended by an O(n^2 m) block-Cholesky update
        instead of a refit. x_new is in raw input units, like a predict
        input.

        An exact-shape posterior returns a new posterior and is not
        modified (`_extend_dense` of the JAX package); a column-block
        factor gains its rows block by block
        (`ops.linalg.block_cholesky_append_rows`). A padded one
        (`fit_gp(pad_to=)`) writes the rows into its pad slots in place and
        returns itself; when the slots run out it returns the dense
        extend of `strip_padding()` instead. bucket (padded only): round
        the appended block up to max(bucket, the next power of two >= m)
        with inert rows, which stay unit rows and reusable; only the m
        real rows advance n_real, and the slot check is against the
        bucketed size, as in the JAX package. A failed in-place extend
        raises before anything is written.

        The fit's ridge is kept: a relative ridge is defined by the
        fit-time Gram, and deriving it again from the extended Gram would
        change the model the factor represents. K22 gets the exact
        diagonal from `gram_sym`, as the fit's Gram did."""
        x_new, y_new = self._check_rows(x_new, y_new)
        if self.n_real is None:
            return self._extend_dense(x_new, y_new)
        m = x_new.shape[0]
        mb = m if bucket is None else max(int(bucket),
                                          1 << (m - 1).bit_length())
        if self.n_real + mb > self.num_padded:
            return self.strip_padding()._extend_dense(x_new, y_new)
        self._padded_append(x_new, y_new, mb)
        return self

    def _check_rows(self, x_new, y_new):
        """(x_new, y_new (m, 1)) as tensors of the posterior's dtype on
        its device, checked."""
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
        return x_new, y_new

    def _padded_append(self, x_new, y_new, mb: int):
        """Write the m rows, bucketed to mb, into the pad slots from
        n_real on (`_padded_append` of the JAX package). Bucket-pad rows
        are copies of the first new row with a zero label and no kernel
        row: the Schur block comes out the identity there."""
        r, m = self.n_real, x_new.shape[0]
        if self.input_scale != 1.0:
            x_new = x_new * (1.0 / self.input_scale)
        if mb > m:
            x_new = torch.cat([x_new, x_new[:1].expand(mb - m, -1)])
            y_new = torch.cat([y_new, y_new.new_zeros((mb - m, 1))])
        k21 = x_new.new_zeros((m, self.num_padded))
        gram_cross(self.spec, x_new[:m], self.x_train[:r], "nngp",
                   out=k21[:, :r])
        k22 = torch.eye(mb, dtype=x_new.dtype, device=x_new.device)
        gram_sym(self.spec, x_new[:m], "nngp", diag_add=self.reg,
                 out=k22[:m, :m])
        try:
            padded_append_rows_(self.l, self.y_train, self.alpha, r, k21,
                                k22, y_new)
        except FactorError as err:
            err.diag_reg = self.diag_reg
            raise
        self.x_train[r:r + mb].copy_(x_new)
        self.row_mask[r:r + m] = 1
        self.n_real = r + m

    def strip_padding(self) -> "GPPosterior":
        """The exact-shape posterior of a padded one: its real rows, in
        new tensors (self when not padded)."""
        if self.n_real is None:
            return self
        n = self.n_real
        return dataclasses.replace(
            self, x_train=self.x_train[:n].clone(),
            y_train=self.y_train[:n].clone(), l=self.l[:n, :n].clone(),
            alpha=self.alpha[:n].clone(), n_real=None, row_mask=None)

    def _extend_dense(self, x_new, y_new) -> "GPPosterior":
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
            if isinstance(self.l, BlockLowerTriangular):
                l = block_cholesky_append_rows(self.l, k21, k22)
            else:
                l = cholesky_append_rows(self.l, k21, k22)
        except FactorError as err:
            err.diag_reg = self.diag_reg
            raise
        y = torch.cat([self.y_train, y_new])
        alpha = _tri_solve(l, _tri_solve(l, y), transpose=True)
        k_tt = None
        if self.k_tt_nngp is not None:   # a lazy K_tt stays lazy
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
    if _probe_site(x, layers) == "skipped":
        return 1.0
    if isinstance(x, torch.Tensor):
        m = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    else:
        x = np.asarray(x)
        m = float(np.max(np.abs(x))) if x.size else 0.0
    return input_scale_for_bound(m, layers)


def _probe_site(x, layers) -> str:
    """Where `_auto_input_scale(x, layers)` reads max|x|, for a fit's
    prepare span: 'skipped' where it reads nothing (fp64 rows, or a spec
    that is not scale-equivariant), 'device' on a card's tensor, else
    'host'."""
    if isinstance(x, torch.Tensor):
        fp64, where = x.dtype == torch.float64, x.device.type
    else:
        fp64, where = np.asarray(x).dtype == np.float64, "cpu"
    if fp64 or not is_scale_equivariant(layers):
        return "skipped"
    return "host" if where == "cpu" else "device"


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
           pad_to: Optional[int] = None, device=None) -> GPPosterior:
    """Factorize the train Gram and return a ready posterior.

    x_train, y_train: numpy arrays or tensors (float32 or float64; the
    dtype of x_train is the working dtype). device: where the posterior
    lives; required for numpy input, and for a tensor it defaults to the
    tensor's own device.

    input_scale: None picks an automatic power-of-two prescale when fp32
    features would overflow the Gram; pass 1.0 to force raw features.

    pad_to (get='nngp' only): a padded posterior of pad_to storage rows,
    n real and pad_to - n inert (copies of row 0, zero labels, unit factor
    rows, masked out of every cross Gram), that `extend` fills in place.
    The ridge is relative to the real rows' diagonal; the Gram, the
    factor and alpha's solves cover the n real rows, in the leading block
    of the factor's storage, and the pad's unit factor rows and zero
    alpha rows are written beside them. At most `dense_exact_max_n` of
    the device, dtype and kernel.

    Above `dense_exact_max_n` (unpadded) the factor is column blocks, and
    an NTK posterior keeps no train NNGP Gram (module docstring).

    A ridged Gram that is not positive definite in the working dtype
    raises `ops.linalg.FactorError` (a FloatingPointError naming n, the
    failing order, the dtype and diag_reg), after its n x n tensors or
    its blocks are freed; the JAX fit returns a NaN factor there."""
    if get not in ("nngp", "ntk"):
        raise ValueError(f"get must be 'nngp' or 'ntk', got {get!r}")
    if device is None:
        if not isinstance(x_train, torch.Tensor):
            raise ValueError("fit_gp needs device= for numpy input")
        device = x_train.device
    device = resolve_device(device)
    with span("exact.fit", rows=len(x_train), get=get,
              pad_to=None if pad_to is None else int(pad_to)) as fit_span:
        with span("exact.prepare", rows=len(x_train),
                  probe="given" if input_scale is not None
                  else _probe_site(x_train, spec.layers)):
            if input_scale is None:
                input_scale = _auto_input_scale(x_train, spec.layers)
            x = _as_tensor(x_train, device)
            if x.dtype not in (torch.float32, torch.float64):
                raise TypeError("x_train must be float32 or float64, got "
                                f"{x.dtype}")
            y = _as_tensor(y_train, device, x.dtype)
            if y.dim() == 1:
                y = y[:, None]
            if input_scale != 1.0:
                x = x * (1.0 / input_scale)
            n = x.shape[0]
            if pad_to is not None:
                pad_to = int(pad_to)
                cap = _dense_cap(device, x.dtype, get)
                if get != "nngp":
                    raise ValueError(
                        "pad_to supports get='nngp' only (the padded NTK "
                        "covariance needs a masked resident k_tt; not "
                        "implemented)")
                if pad_to < n:
                    raise ValueError(f"pad_to={pad_to} < n={n}")
                if pad_to > cap:
                    raise ValueError(
                        f"pad_to={pad_to} exceeds {cap}, the dense factor "
                        f"layout's dense_exact_max_n for {get} in "
                        f"{str(x.dtype).replace('torch.', '')} on {device}: "
                        "padding is a dense-layout feature, and the "
                        "column-block layout that serves the exact tier "
                        "beyond it up to default_exact_max_n takes none")
            diag = diag_eval(spec.layers, x, ("nngp", "ntk"))
            reg = solve_ridge(diag, get, diag_reg, diag_reg_absolute_scale)
        row_mask = k_tt_nngp = None
        if pad_to is not None:
            layout, storage = "padded", pad_to
        elif uses_block_layout(n, device, x.dtype, get):
            layout, storage = "blocks", n
        else:
            layout, storage = "dense", n
        fit_span.set(layout=layout,
                     dtype=str(x.dtype).replace("torch.", ""))
        if layout == "blocks":
            with span("exact.factor", rows=n, storage_rows=storage,
                      factor_rows=n, layout=layout):
                try:
                    l = _block_factor(spec, x, reg, diag, get)
                except FactorError as err:
                    err.diag_reg = diag_reg
                    raise
            fit_span.set(blocks=len(l.blocks), factor_bytes=sum(
                b.numel() * b.element_size() for b in l.blocks))
        else:
            # padded or not, the Gram, the factor and the solves cover the
            # n real rows, in the leading block of the factor's storage:
            # the inert-padded Gram is [K + rI, 0; 0, I], whose factor
            # [L, 0; 0, I] keeps the pad's exact zeros and unit diagonal.
            # The Gram is symmetric: its rows, written p apart into the
            # column-major storage's transpose, are the storage's columns.
            with span("exact.gram", rows=n, storage_rows=storage):
                l = _factor_storage(x, n, storage)
                if get == "nngp":
                    gram_sym(spec, x, "nngp", diag_add=reg, diag=diag,
                             out=l.mT[:n, :n])
                else:
                    k_tt_nngp = x.new_empty((n, n))
                    gram_sym(spec, x, ("nngp", "ntk"), diag_add=reg,
                             diag=diag, out=(k_tt_nngp, l.mT[:n, :n]))
                if layout == "padded":
                    x = torch.cat([x, x[:1].expand(pad_to - n, -1)])
                    y = torch.cat([y, y.new_zeros((pad_to - n, y.shape[1]))])
                    row_mask = x.new_zeros(pad_to)
                    row_mask[:n] = 1.0
            with span("exact.factor", rows=n, storage_rows=storage,
                      factor_rows=n, layout=layout) as factor_span:
                info, in_place = _factor_block_(l[:n, :n])
                factor_span.set(in_place=in_place)
                if int(info):
                    # the traceback keeps this frame alive: drop the n x n
                    # tensors first, so that a caller's fallback fit has
                    # the memory
                    del l, k_tt_nngp
                    raise FactorError("fit", int(info), n, x.dtype, diag_reg)
        with span("exact.solve", rows=n):
            real = l if layout == "blocks" else l[:n, :n]
            alpha = _tri_solve(real, _tri_solve(real, y[:n]), transpose=True)
            if layout == "padded":
                alpha = torch.cat(
                    [alpha, alpha.new_zeros((pad_to - n, alpha.shape[1]))])
        return GPPosterior(
            x_train=x, y_train=y, l=l, alpha=alpha, reg=reg,
            k_tt_nngp=k_tt_nngp, spec=spec, get=get, diag_reg=diag_reg,
            input_scale=float(input_scale),
            n_real=None if pad_to is None else n, row_mask=row_mask)


def _factor_storage(x: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """The (p, p) storage of the factor [L, 0; 0, I] of n real rows, in
    x's dtype and on its device, column-major (cuSOLVER's order, in which
    `potrf_lower_` factors in place): the pad's exact zeros and unit
    diagonal written, the leading (n, n) block left for the Gram and its
    factor."""
    out = x.new_empty((p, p)).mT
    out[:n, n:] = 0.0
    out[n:] = 0.0
    out.diagonal()[n:] = 1.0
    return out


def _factor_block_(a: torch.Tensor):
    """Factor the ridged Gram `a`, the leading block of the factor's
    storage, in place into its lower Cholesky factor, the strict upper
    triangle zeroed: (info, in_place). info: 0, or the 1-based order of
    the leading minor that is not positive definite, a tensor not read
    here. in_place: True on the card, where cuSOLVER factors the storage
    itself (`ops.cusolver.potrf_lower_`); False on the CPU, where
    `torch.linalg.cholesky_ex` factors a copy that is written back."""
    if a.is_cuda:
        return potrf_lower_(a), True
    l, info = torch.linalg.cholesky_ex(a)
    a.copy_(l)
    return info, False


def _block_factor(spec: KernelSpec, x, reg, diag, get: str
                  ) -> BlockLowerTriangular:
    """chol(K_get + reg I) of the rows x as column blocks _BLOCK_PANEL wide
    (`fused_panel_cholesky`): block k's panel K[s:, s:e] is written into
    its own storage, the diagonal square by `gram_sym` (the exact diagonal
    `diag` and the ridge fused in) and the rows below by `gram_cross`. The
    kernels write the ntk Gram beside the nngp one, so for get='ntk' the
    nngp half goes to an (n - s, w) scratch panel, freed with the step."""
    n = x.shape[0]
    pair = ("nngp", "ntk")

    def panel_fn(s, e, out):
        w, xs = e - s, x[s:e]
        sub = (diag[0][s:e], diag[1][s:e])
        if get == "nngp":
            gram_sym(spec, xs, "nngp", diag_add=reg, diag=sub, out=out[:w])
            if e < n:
                gram_cross(spec, x[e:], xs, "nngp", out=out[w:])
            return
        scratch = torch.empty_like(out)
        gram_sym(spec, xs, pair, diag_add=reg, diag=sub,
                 out=(scratch[:w], out[:w]))
        if e < n:
            gram_cross(spec, x[e:], xs, pair, out=(scratch[w:], out[w:]))

    return fused_panel_cholesky(panel_fn, n, x.dtype, _BLOCK_PANEL,
                                layout="blocks", device=x.device)


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
