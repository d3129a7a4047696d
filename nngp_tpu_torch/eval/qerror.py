"""Cardinality-error statistics.

A copy of `nngp_tpu/eval/qerror.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

The reference's metric pipeline (`reference/util.py:94-167`): errors are
(pred - truth) in log2-card space, back-transformed via 2^error into the
*ratio* pred_card / true_card, then profiled by quantiles — optionally
partitioned by query attributes (#tables / #joins / #predicates) with the
same bucket-merging rule when more than 6 groups exist
(`reference/util.py:129-140`).

Two metrics are exposed:
  - `qerror_profile` — the reference's exact statistic (2^(pred - truth),
    can be < 1), used for parity checks against reference output.
  - `symmetric_qerror` — the standard q-error max(r, 1/r) the paper reports.
"""

from typing import Dict, Sequence

import numpy as np


def ratio_errors(log2_errors: np.ndarray) -> np.ndarray:
    return np.power(2.0, np.asarray(log2_errors, dtype=np.float64))


def symmetric_qerror(log2_errors: np.ndarray) -> np.ndarray:
    r = ratio_errors(log2_errors)
    return np.maximum(r, 1.0 / r)


def qerror_profile(errors: np.ndarray, already_ratio: bool = False) -> Dict[str, float]:
    """Quantile profile of ratio errors, mirroring
    `reference/util.py:152-167`."""
    e = np.asarray(errors, dtype=np.float64)
    if not already_ratio:
        e = ratio_errors(e)
    return {
        "count": int(e.size),
        "min": float(np.min(e)),
        "max": float(np.max(e)),
        "mean": float(np.mean(e)),
        "median": float(np.median(e)),
        "q25": float(np.quantile(e, 0.25)),
        "q75": float(np.quantile(e, 0.75)),
        "q5": float(np.quantile(e, 0.05)),
        "q95": float(np.quantile(e, 0.95)),
    }


def format_profile(profile: Dict[str, float]) -> str:
    return (
        "<" * 80 + "\n"
        f"Predict Result Profile of {profile['count']} Queries:\n"
        f"Min/Max: {profile['min']:.15f} / {profile['max']:.15f}\n"
        f"Mean: {profile['mean']:.8f}\n"
        f"Median: {profile['median']:.8f}\n"
        f"25%/75% Quantiles: {profile['q25']:.8f} / {profile['q75']:.8f}\n"
        f"5%/95% Quantiles: {profile['q5']:.8f} / {profile['q95']:.8f}\n"
        + ">" * 80
    )


class PredictionStatistics:
    """Attribute-partitioned error reporting
    (`reference/util.py:107-167`)."""

    KEYS = ("num_table", "num_joins", "num_predicates")

    def _parse_keys(self, keys: str):
        keys = [k.strip() for k in keys.strip().split(",")]
        for k in keys:
            if k not in self.KEYS:
                raise ValueError(f"Unsupported partition key {k!r}")
        return keys

    def get_partitioned_indices(self, query_infos: Sequence, part_keys: str):
        keys = self._parse_keys(part_keys)
        partition: Dict[tuple, list] = {}
        for i, info in enumerate(query_infos):
            attrs = tuple(getattr(info, k) for k in keys)
            partition.setdefault(attrs, []).append(i)
        return partition

    def get_permutation_index(self, query_infos, perm_keys: str = ""):
        if not perm_keys:
            return np.arange(len(query_infos))
        partition = self.get_partitioned_indices(query_infos, perm_keys)
        perm = []
        for attrs in sorted(partition.keys()):
            perm += partition[attrs]
        return np.asarray(perm)

    def get_partitioned_data(self, x, query_infos, part_keys: str):
        partition = self.get_partitioned_indices(query_infos, part_keys)
        out = []
        for attrs in sorted(partition.keys()):
            idx = partition[attrs]
            if isinstance(x, list):
                out.append([x[i] for i in idx])
            else:
                out.append(np.asarray(x)[np.asarray(idx)])
        return out

    def get_prediction_details(self, errors, query_infos=None,
                               partition_keys: str = "", printer=print):
        """Partitioned profiles; returns {attrs: profile}. Merges adjacent
        buckets pairwise when >6 groups (`reference/util.py:129-140`)."""
        errors = np.asarray(errors)
        if query_infos is None or not partition_keys:
            profile = qerror_profile(errors)
            if printer:
                printer(format_profile(profile))
            return {(): profile}

        keys = self._parse_keys(partition_keys)
        partition_errors: Dict[tuple, list] = {}
        for err, info in zip(errors.tolist(), query_infos):
            attrs = tuple(getattr(info, k) for k in keys)
            partition_errors.setdefault(attrs, []).append(err)

        if len(partition_errors) > 6:
            items = [(a, partition_errors[a]) for a in sorted(partition_errors)]
            merged = {}
            for i, (attrs, errs) in enumerate(items):
                if i % 2 == 0 and i < len(items) - 1:
                    continue
                elif i % 2 == 1:
                    merged[attrs] = errs + items[i - 1][1]
                else:
                    merged[attrs] = errs
            partition_errors = merged

        results = {}
        for attrs in sorted(partition_errors.keys()):
            profile = qerror_profile(np.asarray(partition_errors[attrs]))
            results[attrs] = profile
            if printer:
                info_str = ",".join(f"{k}={a}" for k, a in zip(keys, attrs))
                printer(f"Query attributes:{info_str}")
                printer(f"# Queries = {profile['count']}")
                printer(format_profile(profile))
        return results
