"""Single-table workload assembly without pandas: query files + stats ->
(X, Y, query_infos, encoder).

Counterpart of `nngp_tpu/data/workload.py:21-54,134-147` for the
single-table path. Column stats come from a `<name>_stats.json` next to the
query directory or from a scan of the query files themselves; the raw-CSV
branch needs pandas (`nngp_tpu/data/loaders.py`) and is not ported yet.
This module imports `nngp_tpu.featurize` directly: importing `nngp_tpu.data`
would pull in pandas.
"""

import os
from typing import Optional

import numpy as np

from nngp_tpu.featurize.encoder import SingleTableEncoder
from nngp_tpu.featurize.parser import load_single_table_queries
from nngp_tpu.featurize.stats import TableStats


def single_table_stats(name: str, query_path: str,
                       data_path: Optional[str] = None,
                       chunk_size: int = 64) -> TableStats:
    if data_path:
        raise NotImplementedError(
            "CSV loading not ported yet (ROADMAP Queue A: data loaders); "
            "drop --data_path to take the stats from the query files")
    stats_json = os.path.join(query_path, os.pardir, f"{name}_stats.json")
    if os.path.exists(stats_json):
        return TableStats.load(stats_json)
    return TableStats.from_query_files(query_path, _discover_columns(query_path),
                                       name, chunk_size=chunk_size)


def _discover_columns(query_path: str):
    names = set()
    for fname in sorted(os.listdir(query_path)):
        with open(os.path.join(query_path, fname)) as f:
            for line in f:
                body = line.strip().split("@")[0]
                if not body:
                    continue
                for pred in body.split("#"):
                    names.add(pred.split(",")[0].strip())
    return sorted(names)


def load_single_table_workload(query_path: str,
                               stats: Optional[TableStats] = None,
                               name: str = "forest",
                               data_path: Optional[str] = None,
                               chunk_size: int = 64, dtype=np.float64,
                               chunk_norm: bool = False):
    """Returns (X, Y, query_infos, encoder) as numpy arrays."""
    if stats is None:
        stats = single_table_stats(name, query_path, data_path,
                                   chunk_size=chunk_size)
    queries, cards, infos = load_single_table_queries(query_path, stats)
    encoder = SingleTableEncoder(stats, chunk_norm=chunk_norm)
    x, y = encoder.transform_to_arrays(queries, cards, dtype=dtype)
    return x, y, infos, encoder
