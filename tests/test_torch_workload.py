"""The port's pandas-free multi-join loader (`nngp_tpu_torch.data.workload`)
against the JAX package's `load_multi_join_workload`, on the committed
3-table `synth` and 6-table `synth6` workloads: the same features and
labels bit for bit, and the same table order for the named schemas."""

import os

import numpy as np
import pytest

from nngp_tpu.data.loaders import SCHEMAS
from nngp_tpu.data.workload import load_multi_join_workload as jax_load
from nngp_tpu_torch.data.workload import (SCHEMA_TABLES,
                                          load_multi_join_workload,
                                          schema_stats)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = os.path.join(REPO, "workloads")


@pytest.mark.parametrize("schema,queries,chunk_norm", [
    ("synth", "synth_join_data", False),
    ("synth", "synth_join_data", True),
    ("synth6", "synth6_join_data", False),
], ids=["synth", "synth-chunk_norm", "synth6"])
def test_multi_join_loader_matches_jax(schema, queries, chunk_norm):
    path = os.path.join(WORKLOADS, queries)
    x, y, infos, enc = load_multi_join_workload(
        path, schema_name=schema, dtype=np.float64, chunk_norm=chunk_norm)
    jx, jy, jinfos, jenc = jax_load(path, schema_name=schema,
                                    dtype=np.float64, chunk_norm=chunk_norm)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert infos == jinfos
    assert [t.table_name for t in enc.tables] == \
        [t.table_name for t in jenc.tables]


def test_schema_table_order_is_the_jax_schemas():
    assert SCHEMA_TABLES == {name: tuple(tables)
                             for name, (_loaders, tables) in SCHEMAS.items()}


def test_stats_dir_order_follows_the_schema(tmp_path):
    """A named schema's stats are laid out in its table order, not in the
    files' sorted order; other schemas keep the sorted order."""
    from nngp_tpu.featurize.stats import ColumnStats, TableStats

    for i, name in enumerate(("supplier", "part", "orders", "lineitem")):
        TableStats(name, (ColumnStats("k", "numerical", 0, 10),),
                   chunk_size=8).save(str(tmp_path / f"{i}_{name}.json"))
    assert [t.table_name for t in schema_stats("tpch", str(tmp_path))] == \
        ["lineitem", "part", "orders", "supplier"]
    assert [t.table_name for t in schema_stats("other", str(tmp_path))] == \
        ["supplier", "part", "orders", "lineitem"]


def test_data_path_and_missing_stats_raise(tmp_path):
    path = os.path.join(WORKLOADS, "synth_join_data")
    with pytest.raises(NotImplementedError, match="CSV loading not ported"):
        load_multi_join_workload(path, schema_name="synth",
                                 data_path="raw_csvs")
    qdir = tmp_path / "queries"
    qdir.mkdir()
    with pytest.raises(FileNotFoundError, match="stats dir"):
        load_multi_join_workload(str(qdir), schema_name="nope")
