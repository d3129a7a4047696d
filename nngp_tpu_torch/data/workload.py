"""Workload assembly without pandas: query files + stats ->
(X, Y, query_infos, encoder).

Counterpart of `nngp_tpu/data/workload.py`. Single-table column stats come
from the raw CSV (`data/loaders.py`, when `data_path` holds the relation's
file), else from a `<name>_stats.json` next to the query directory, else
from a scan of the query files themselves, as in the original. Multi-join
stats come from the schema's raw CSVs through `DBSchema`, or from a
directory of TableStats JSONs; binary-join stats from the two relations'
CSVs. The encoders are the port's own copies in `nngp_tpu_torch.featurize`.
"""

import os
from typing import Optional

import numpy as np

from nngp_tpu_torch.data.loaders import SCHEMAS, load_schema, load_table
from nngp_tpu_torch.featurize.encoder import SingleTableEncoder
from nngp_tpu_torch.featurize.join import BinaryJoinEncoder, MultiJoinEncoder
from nngp_tpu_torch.featurize.parser import load_single_table_queries
from nngp_tpu_torch.featurize.schema import DBSchema
from nngp_tpu_torch.featurize.stats import TableStats, load_stats_dir


def single_table_stats(relation: str, name: str, query_path: str,
                       data_path: Optional[str] = None,
                       chunk_size: int = 64,
                       nrows: Optional[int] = None) -> TableStats:
    csv_ok = False
    if data_path:
        try:
            df, col_types = load_table(relation, data_path, nrows=nrows)
            csv_ok = True
        except (FileNotFoundError, ValueError):
            csv_ok = False
    if csv_ok:
        return TableStats.from_dataframe(df, col_types, name,
                                         chunk_size=chunk_size)
    # Stats JSON artifact next to the queries?
    stats_json = os.path.join(query_path, os.pardir, f"{name}_stats.json")
    if os.path.exists(stats_json):
        return TableStats.load(stats_json)
    # Fall back to scanning the query files (numerical-only workloads).
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


# Table order of the named schemas: the order defines the feature layout,
# so stats from a directory are laid out in it. Schemas not listed keep
# the sorted-filename order of `load_stats_dir`.
SCHEMA_TABLES = {name: tuple(tables) for name, (_fns, tables)
                 in SCHEMAS.items()}


def schema_stats(schema_name: str, stats_dir: str):
    """The schema's TableStats list from a directory of TableStats JSONs,
    in the schema's table order."""
    names = SCHEMA_TABLES.get(schema_name)
    return load_stats_dir(stats_dir,
                          table_names=list(names) if names else None)


def schema_stats_from_csvs(schema_name: str, data_path: str,
                           chunk_size: int = 64):
    """The schema's TableStats list from its raw CSVs: every table read by
    its loader, PK/FK codes shared through `DBSchema`."""
    tables, col_types_list, pks, names = load_schema(schema_name, data_path)
    return DBSchema(tables, col_types_list, names, pks, chunk_size).stats


def load_multi_join_workload(query_path: str, schema_name: str = None,
                             data_path: Optional[str] = None,
                             stats_list=None, chunk_size: int = 64,
                             dtype=np.float64, use_aux: bool = False,
                             q_error_threshold: float = 100.0,
                             coef_var_threshold: float = 1.0,
                             chunk_norm: bool = False):
    """Multi-join workload -> (X, Y, query_infos, encoder)
    (`nngp_tpu/data/workload.py:58-105`). Table stats come from the raw
    CSVs (schema_name + data_path), or from a `<schema_name>_stats/`
    directory of TableStats JSONs next to the queries, or are passed
    directly (stats_list)."""
    if stats_list is None:
        stats_dir = os.path.join(query_path, os.pardir, f"{schema_name}_stats")
        if data_path:
            stats_list = schema_stats_from_csvs(schema_name, data_path,
                                                chunk_size)
        elif os.path.isdir(stats_dir):
            stats_list = schema_stats(schema_name, stats_dir)
        else:
            raise FileNotFoundError(
                f"need --data_path or a stats dir {stats_dir}")
    encoder = MultiJoinEncoder(stats_list, chunk_norm=chunk_norm)
    queries, cards, infos = encoder.load_queries(
        query_path, use_aux=use_aux, q_error_threshold=q_error_threshold,
        coef_var_threshold=coef_var_threshold)
    x, y = encoder.transform_to_arrays(queries, cards, dtype=dtype)
    return x, y, infos, encoder


def load_binary_join_workload(query_path: str, relations=None, names=None,
                              data_path: Optional[str] = None,
                              stats_pair=None, chunk_size: int = 64,
                              dtype=np.float64, chunk_norm: bool = False):
    """Two-table join workload (`t1p@t2p@joins@card` grammar) ->
    (X, Y, query_infos, encoder). The `--relations a,b` path
    (`nngp_tpu/data/workload.py:108-132`); each relation's stats come from
    the first 100,000 rows of its CSV."""
    if stats_pair is None:
        if not (relations and data_path):
            raise ValueError("need stats_pair or (relations + data_path)")
        rels = [r.strip() for r in relations.split(",")]
        nms = ([n.strip() for n in names.split(",")]
               if names else rels)
        stats_pair = []
        for rel, nm in zip(rels, nms):
            df, col_types = load_table(rel, data_path, nrows=100000)
            stats_pair.append(TableStats.from_dataframe(
                df, col_types, nm, chunk_size=chunk_size))
    encoder = BinaryJoinEncoder(stats_pair[0], stats_pair[1],
                                chunk_norm=chunk_norm)
    queries, cards, infos = encoder.load_queries(query_path)
    x, y = encoder.transform_to_arrays(queries, cards, dtype=dtype)
    return x, y, infos, encoder


def load_single_table_workload(query_path: str,
                               stats: Optional[TableStats] = None,
                               relation: str = "forest", name: str = "forest",
                               data_path: Optional[str] = None,
                               chunk_size: int = 64, dtype=np.float64,
                               chunk_norm: bool = False):
    """Returns (X, Y, query_infos, encoder) as numpy arrays."""
    if stats is None:
        stats = single_table_stats(relation, name, query_path, data_path,
                                   chunk_size=chunk_size)
    queries, cards, infos = load_single_table_queries(query_path, stats)
    encoder = SingleTableEncoder(stats, chunk_norm=chunk_norm)
    x, y = encoder.transform_to_arrays(queries, cards, dtype=dtype)
    return x, y, infos, encoder
