"""Vectorized feature encoders.

A copy of `nngp_tpu/featurize/encoder.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

The reference encodes queries one at a time in a Python loop
(`transform_to_arrays` at `reference/QuerySampler.py:188-197` — flagged
HOT in SURVEY.md section 3.1). Here a parsed batch is lowered to flat index /
value arrays once and the feature matrix is built with numpy scatter ops —
bit-identical output, orders of magnitude less Python dispatch, and the
result is ready to ship to device HBM as one contiguous fp32/fp64 array.

Layout and conventions are defined by `TableStats` (see stats.py docstring).
Labels are Y = log2(card), shape (n, 1)
(`reference/QuerySampler.py:195-197`).
"""

from typing import List, Sequence

import numpy as np

from nngp_tpu_torch.featurize.stats import CATEGORICAL, NUMERICAL, TableStats


class SingleTableEncoder:
    """Equivalent of GeneralQuerySampler's encoding surface
    (`reference/QuerySampler.py:188-235`).

    chunk_norm=True rescales the factorized categorical chunk slots by
    1000 / 2^chunk_size, putting them on the SAME [0, 1000] scale as the
    numerical range slots. The reference feeds the raw packed integers
    (up to 2^64 for chunk_size=64, `reference/QuerySampler.py:224-235`)
    into the kernel, where they drown out every numerical predicate —
    measured on the 6-table join workload this imbalance costs 3.4x median
    q-error (10.2 -> 2.98) and 125x p95 (5504 -> 44). Off by default for
    bit-exact reference parity; deterministic (a fixed power-of-two factor,
    no data-dependent statistics)."""

    def __init__(self, stats: TableStats, chunk_norm: bool = False):
        self.stats = stats
        self.chunk_norm = bool(chunk_norm)
        self._default = stats.default_row()
        # Precompute per-column scale/shift for numerical columns.
        self._mins = np.array(
            [c.min if c.kind == NUMERICAL else 0.0 for c in stats.columns]
        )
        # Keep the reference's exact op order (v - min) / denom * 1000 for
        # bit-identical features (`reference/QuerySampler.py:215-219`).
        self._denoms = np.array(
            [c.denominator if c.kind == NUMERICAL else 1.0 for c in stats.columns]
        )
        self._starts = np.array([a.start for a in stats.addresses])
        # per-feature-slot scale: 1 everywhere, 1000/2^chunk on chunk slots
        self.col_scale = np.ones(stats.feat_dim, dtype=np.float64)
        if self.chunk_norm:
            factor = 1000.0 / 2.0 ** stats.chunk_size
            for col, addr in zip(stats.columns, stats.addresses):
                if col.kind == CATEGORICAL:
                    self.col_scale[addr.start:addr.end] = factor

    @property
    def feat_dim(self) -> int:
        return self.stats.feat_dim

    def max_abs_bound(self) -> float:
        """Largest feature magnitude this encoder can emit, from the LAYOUT
        alone (no data probe): numeric range slots are scaled onto [0,1000]
        (an out-of-range literal can exceed 1000, but never by the orders
        of magnitude the bound exists to cover), factorized chunk slots
        reach 2^chunk_size - 1 raw (< 1000 under chunk_norm). Can seed the
        fp32 fit prescale (`gp.posterior.input_scale_for_bound`) without a
        device round-trip — but ONLY when the training data actually spans
        the bound; see that function's underflow caveat."""
        bound = 1000.0
        if any(c.kind == CATEGORICAL for c in self.stats.columns):
            chunk_max = 2.0 ** self.stats.chunk_size - 1.0
            if self.chunk_norm:
                chunk_max *= 1000.0 / 2.0 ** self.stats.chunk_size
            bound = max(bound, chunk_max)
        return bound

    def encode_batch(self, pred_lists: Sequence[List], dtype=np.float64) -> np.ndarray:
        """(n, feat_dim) feature matrix for a batch of parsed predicate lists."""
        n = len(pred_lists)
        x = np.tile(self._default.astype(dtype), (n, 1))

        num_rows, num_cols, num_up, num_lo = [], [], [], []
        cat_rows, cat_slots, cat_vals = [], [], []
        chunk = self.stats.chunk_size
        for row, preds in enumerate(pred_lists):
            for pred in preds:
                col_idx = pred[0]
                if self.stats.columns[col_idx].kind == CATEGORICAL:
                    start = self._starts[col_idx]
                    # set(): the reference sets each one-hot bit
                    # idempotently (encoding_str[cat] = '1'); a duplicate
                    # code in the IN-list must not double the chunk value
                    for code in set(pred[1]):
                        cat_rows.append(row)
                        cat_slots.append(start + code // chunk)
                        cat_vals.append(2.0 ** (chunk - 1 - code % chunk))
                else:
                    num_rows.append(row)
                    num_cols.append(col_idx)
                    num_up.append(pred[1])
                    num_lo.append(pred[2])

        if num_rows:
            rows = np.asarray(num_rows)
            cols = np.asarray(num_cols)
            up = (np.asarray(num_up) - self._mins[cols]) / self._denoms[cols] * 1000.0
            lo = (np.asarray(num_lo) - self._mins[cols]) / self._denoms[cols] * 1000.0
            starts = self._starts[cols]
            x[rows, starts] = up
            x[rows, starts + 1] = lo
        if cat_rows:
            # += accumulates bits that land in the same factorized chunk
            np.add.at(x, (np.asarray(cat_rows), np.asarray(cat_slots)),
                      np.asarray(cat_vals, dtype=dtype))
        if self.chunk_norm:
            x *= self.col_scale.astype(dtype)
        return x

    def encode_one(self, pred_list: List, dtype=np.float64) -> np.ndarray:
        return self.encode_batch([pred_list], dtype=dtype)[0]

    def transform_to_arrays(self, all_queries, all_cards, dtype=np.float64):
        """(X, Y) with Y = log2(card), mirroring
        `reference/QuerySampler.py:188-197`."""
        x = self.encode_batch(all_queries, dtype=dtype)
        y = np.log2(np.asarray(all_cards, dtype=np.float64)).reshape(-1, 1).astype(dtype)
        return x, y


class SplitLayoutEncoder:
    """Legacy QuerySet encoding convention: X = [all uppers ; all lowers]
    halves instead of per-column (upper, lower) pairs
    (`reference/QuerySet.py:44-64`). Numerical-only; defaults
    upper = 0, lower = 1000. Kept because older query sets were trained with
    this layout (the class itself is superseded — its loader has an
    uninitialized-attribute bug, SURVEY.md section 5 quirks)."""

    def __init__(self, stats: TableStats):
        for c in stats.columns:
            if c.kind != NUMERICAL:
                raise ValueError("SplitLayoutEncoder supports numerical "
                                 "columns only (QuerySet legacy layout)")
        self.stats = stats

    @property
    def feat_dim(self) -> int:
        return 2 * self.stats.num_cols

    def encode_batch(self, pred_lists, dtype=np.float64) -> np.ndarray:
        n = len(pred_lists)
        c = self.stats.num_cols
        x = np.hstack([np.zeros((n, c)), np.full((n, c), 1000.0)]).astype(dtype)
        for row, preds in enumerate(pred_lists):
            for col_idx, upper, lower in preds:
                col = self.stats.columns[col_idx]
                x[row, col_idx] = (upper - col.min) / col.denominator * 1000
                x[row, c + col_idx] = (lower - col.min) / col.denominator * 1000
        return x

    def transform_to_arrays(self, all_queries, all_cards, dtype=np.float64):
        x = self.encode_batch(all_queries, dtype=dtype)
        y = np.log2(np.asarray(all_cards, dtype=np.float64)).reshape(-1, 1).astype(dtype)
        return x, y
