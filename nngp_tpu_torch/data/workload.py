"""Workload assembly without pandas: query files + stats ->
(X, Y, query_infos, encoder).

Counterpart of `nngp_tpu/data/workload.py` for the single-table path and
the stats branch of the multi-join path. Single-table column stats come
from a `<name>_stats.json` next to the query directory or from a scan of
the query files themselves; multi-join stats from a directory of
TableStats JSONs. The raw-CSV branches need pandas
(`nngp_tpu/data/loaders.py`) and are not ported yet. The encoders are the
port's own copies in `nngp_tpu_torch.featurize`.
"""

import os
from typing import Optional

import numpy as np

from nngp_tpu_torch.featurize.encoder import SingleTableEncoder
from nngp_tpu_torch.featurize.join import MultiJoinEncoder
from nngp_tpu_torch.featurize.parser import load_single_table_queries
from nngp_tpu_torch.featurize.stats import TableStats, load_stats_dir


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


# Table order of the named schemas (`nngp_tpu/data/loaders.py:197-225`):
# the order defines the feature layout, so stats from a directory are laid
# out in it. Only the names are copied: the CSV loaders beside them need
# pandas. Schemas not listed here keep the sorted-filename order of
# `load_stats_dir`.
SCHEMA_TABLES = {
    "yelp": ("business", "review", "user"),
    "tpcds": ("store_sales", "store", "item", "customer", "promotion"),
    "tpch": ("lineitem", "part", "orders", "supplier"),
    "imdb_simple": ("title", "cast_info", "movie_info", "movie_companies",
                    "movie_info_idx", "movie_keyword"),
    "imdb": ("title", "cast_info", "movie_info", "movie_companies",
             "movie_info_idx", "movie_keyword"),
}


def schema_stats(schema_name: str, stats_dir: str):
    """The schema's TableStats list from a directory of TableStats JSONs,
    in the schema's table order."""
    names = SCHEMA_TABLES.get(schema_name)
    return load_stats_dir(stats_dir,
                          table_names=list(names) if names else None)


def load_multi_join_workload(query_path: str, schema_name: str = None,
                             data_path: Optional[str] = None,
                             stats_list=None, dtype=np.float64,
                             use_aux: bool = False,
                             q_error_threshold: float = 100.0,
                             coef_var_threshold: float = 1.0,
                             chunk_norm: bool = False):
    """Multi-join workload -> (X, Y, query_infos, encoder), the stats
    branch of the JAX package's loader (`nngp_tpu/data/workload.py:57-104`):
    stats come from `stats_list` or from a `<schema_name>_stats/`
    directory next to the query directory."""
    if data_path:
        raise NotImplementedError(
            "CSV loading not ported yet (ROADMAP Queue A #7: the pandas CSV "
            "loaders of nngp_tpu/data/loaders.py and featurize/schema.py); "
            "drop --data_path to take the stats from "
            f"<query_path>/../{schema_name}_stats/")
    if stats_list is None:
        stats_dir = os.path.join(query_path, os.pardir, f"{schema_name}_stats")
        if not os.path.isdir(stats_dir):
            raise FileNotFoundError(f"need a stats dir {stats_dir}")
        stats_list = schema_stats(schema_name, stats_dir)
    encoder = MultiJoinEncoder(stats_list, chunk_norm=chunk_norm)
    queries, cards, infos = encoder.load_queries(
        query_path, use_aux=use_aux, q_error_threshold=q_error_threshold,
        coef_var_threshold=coef_var_threshold)
    x, y = encoder.transform_to_arrays(queries, cards, dtype=dtype)
    return x, y, infos, encoder


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
