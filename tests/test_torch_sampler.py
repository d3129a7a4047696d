"""The port's true-cardinality sampler (`nngp_tpu_torch.data.sampler`)
against the JAX package's: the same tables and seeds give identical query
lines (single-table, multi-join and binary-join samplers, data-centric on
and off, every join op), and the exact counters agree with the JAX ones
and its merge oracle on the fuzz, cycle and beyond-2^53 cases of
`tests/test_sampler.py`. Also: the raw-table generators copied into
`chip_smoke.py` write the generators' CSV bytes, and the port's path from
those tables regenerates what `workloads/make_synthtpch.py` makes."""

import filecmp
import os
import sys

import numpy as np
import pandas as pd
import pytest

import nngp_tpu.data.sampler as JS
from nngp_tpu.featurize.join import NUMERICAL_JOIN_OPS
from nngp_tpu.featurize.stats import TableStats as JTableStats
from nngp_tpu_torch.data import sampler as S
from nngp_tpu_torch.data.table import Table
from nngp_tpu_torch.featurize.stats import TableStats
from tests.test_sampler import _JI, _merge_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "workloads"))

import chip_smoke  # noqa: E402
import make_synthtpcds  # noqa: E402
import make_synthtpch  # noqa: E402


def _pair(cols, col_types, name):
    """(port Table, its stats), (DataFrame, the JAX stats) of `cols`."""
    t, df = Table(cols), pd.DataFrame(cols)
    st = TableStats.from_dataframe(t, col_types, name, chunk_size=4)
    jst = JTableStats.from_dataframe(df, col_types, name, chunk_size=4)
    assert st.to_json() == jst.to_json()
    return (t, st), (df, jst)


def _single(seed=0, n=300):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, n).astype(np.float64)
    a[::17] = np.nan                       # gaps: the fill makes them -1.0
    return {"a": a, "b": np.round(rng.uniform(-1, 1, n), 3),
            "c": rng.integers(0, 7, n), "d": rng.integers(0, 12, n)}


_SINGLE_TYPES = ["numerical", "numerical", "categorical", "categorical"]


@pytest.mark.parametrize("data_centric", [False, True])
def test_single_table_sampler_lines_are_the_jax_lines(tmp_path, data_centric):
    (t, st), (df, jst) = _pair(_single(), _SINGLE_TYPES, "t")
    for d in (1, 2, 4):
        got = S.SingleTableSampler(t, st, seed=5).sample_batch_query(
            d, 40, cat_size=3, save_path=str(tmp_path / "p"),
            data_centric=data_centric)
        want = JS.SingleTableSampler(df, jst, seed=5).sample_batch_query(
            d, 40, cat_size=3, save_path=str(tmp_path / "j"),
            data_centric=data_centric)
        assert got == want
    for name in sorted(os.listdir(tmp_path / "j")):
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name,
                           shallow=False)


def _binary_tables(seed=1):
    rng = np.random.default_rng(seed)
    t1 = {"k": rng.integers(0, 10, 60), "m": rng.integers(0, 4, 60),
          "x": np.round(rng.uniform(0, 1, 60), 2), "n": rng.integers(0, 30, 60)}
    t2 = {"k": rng.integers(0, 10, 50), "m": rng.integers(0, 4, 50),
          "n": rng.integers(0, 30, 50), "y": rng.integers(0, 5, 50)}
    types1 = ["numerical", "categorical", "numerical", "numerical"]
    types2 = ["numerical", "categorical", "numerical", "numerical"]
    return (t1, types1), (t2, types2)


@pytest.mark.parametrize("data_centric", [False, True])
def test_binary_join_sampler_lines_are_the_jax_lines(tmp_path, data_centric):
    (c1, ty1), (c2, ty2) = _binary_tables()
    (t1, s1), (d1, j1) = _pair(c1, ty1, "t1")
    (t2, s2), (d2, j2) = _pair(c2, ty2, "t2")
    port = S.BinaryJoinSampler(t1, s1, t2, s2, seed=3)
    jax = JS.BinaryJoinSampler(d1, j1, d2, j2, seed=3)
    assert port.encoder.total_num_joins == 3
    for nj in (1, 2, 3):
        got = port.sample_batch_query(nj, 30, cat_size=2,
                                      save_path=str(tmp_path / "p"),
                                      data_centric=data_centric)
        want = jax.sample_batch_query(nj, 30, cat_size=2,
                                      save_path=str(tmp_path / "j"),
                                      data_centric=data_centric)
        assert got == want


@pytest.mark.parametrize("op2", ["=", "<", "<>"])
@pytest.mark.parametrize("op1", NUMERICAL_JOIN_OPS)
def test_binary_join_counts_every_op_as_jax(op1, op2):
    """One condition (sorted counting), two with an '=' (a join plus a
    filter) and two without (the blocked outer product)."""
    (c1, ty1), (c2, ty2) = _binary_tables(seed=4)
    (t1, s1), (d1, j1) = _pair(c1, ty1, "t1")
    (t2, s2), (d2, j2) = _pair(c2, ty2, "t2")
    port = S.BinaryJoinSampler(t1, s1, t2, s2)
    jax = JS.BinaryJoinSampler(d1, j1, d2, j2)
    preds = [(2, 0.9, 0.1)]
    for conds in ([("k", op1)], [("k", op1), ("n", op2)]):
        assert port.query_true_card(preds, [], conds) == \
            jax.query_true_card(preds, [], conds)


def _schema(cols_list, types_list, names):
    pairs = [_pair(c, t, n) for c, t, n in zip(cols_list, types_list, names)]
    return ([p for p, _ in pairs], [j for _, j in pairs])


def _star(seed=2):
    rng = np.random.default_rng(seed)
    fact = {"ka": rng.integers(0, 12, 200).astype(np.float64),
            "kb": rng.integers(0, 9, 200), "v": rng.integers(0, 100, 200)}
    fact["ka"][::23] = np.nan
    a = {"ka": np.arange(12), "p": np.round(rng.uniform(0, 5, 12), 1)}
    b = {"kb": np.arange(9), "kc": rng.integers(0, 5, 9),
         "q": rng.integers(0, 3, 9)}
    c = {"kc": np.arange(5), "r": rng.integers(0, 50, 5)}
    types = [["numerical"] * 3, ["numerical"] * 2,
             ["numerical", "numerical", "categorical"], ["numerical"] * 2]
    return [fact, a, b, c], types, ["fact", "a", "b", "c"]


@pytest.mark.parametrize("data_centric", [False, True])
def test_multi_join_sampler_lines_are_the_jax_lines(tmp_path, data_centric):
    cols, types, names = _star()
    port, jax = _schema(cols, types, names)
    ps = S.MultiJoinSampler([t for t, _ in port], [s for _, s in port],
                            seed=8)
    js = JS.MultiJoinSampler([d for d, _ in jax], [s for _, s in jax], seed=8)
    for k in (1, 2, 3, 4):
        got = ps.sample_batch_query(str(tmp_path / "p"), k, 25,
                                    data_centric=data_centric, cat_size=2)
        want = js.sample_batch_query(str(tmp_path / "j"), k, 25,
                                     data_centric=data_centric, cat_size=2)
        assert got == want


def test_cycle_closing_edges_count_through_the_merge_path():
    """An edge set with a cycle: `tree_join_count` declines, and the
    merge path's count (NaN keys matching, '==' on the closing edge) is
    the JAX merge path's."""
    rng = np.random.default_rng(9)
    cols = [{"k": rng.integers(0, 5, 40).astype(np.float64),
             "m": rng.integers(0, 3, 40)},
            {"k": rng.integers(0, 5, 30).astype(np.float64),
             "m": rng.integers(0, 3, 30)}]
    cols[0]["k"][::7] = np.nan
    cols[1]["k"][::5] = np.nan
    types = [["numerical", "numerical"]] * 2
    port, jax = _schema(cols, types, ["t0", "t1"])
    ps = S.MultiJoinSampler([t for t, _ in port], [s for _, s in port])
    js = JS.MultiJoinSampler([d for d, _ in jax], [s for _, s in jax])
    for edges in ([_JI(0, 1, "k"), _JI(0, 1, "m")], [_JI(0, 1, "m"),
                                                     _JI(0, 1, "k")]):
        got = ps.query_true_card([0, 1], [[], []], edges)
        assert got == js.query_true_card([0, 1], [[], []], edges)
        assert S.tree_join_count({0: port[0][0], 1: port[1][0]}, edges) is None
        assert got > 0


def _fuzz_tables(rng):
    n_tables = int(rng.integers(2, 6))
    cols, join_infos = {t: {} for t in range(n_tables)}, []
    for t in range(1, n_tables):
        par = int(rng.integers(0, t))
        cols[par][f"j{t}"] = True
        cols[t][f"j{t}"] = True
        join_infos.append(_JI(par, t, f"j{t}"))
    data = {}
    for t in range(n_tables):
        n = int(rng.integers(1, 40))
        d = {"payload": rng.uniform(0, 1, n)}
        for cname in cols[t]:
            vals = rng.integers(0, 6, n).astype(
                float if rng.random() < 0.5 else np.int64)
            if rng.random() < 0.3 and np.issubdtype(vals.dtype, np.floating):
                vals[rng.integers(0, n)] = np.nan
            d[cname] = vals
        data[t] = d
    return data, join_infos


def test_tree_join_count_fuzz_matches_jax_and_the_merge_oracle():
    rng = np.random.default_rng(11)
    for trial in range(30):
        data, join_infos = _fuzz_tables(rng)
        got = S.tree_join_count({t: Table(d) for t, d in data.items()},
                                join_infos)
        frames = {t: pd.DataFrame(d) for t, d in data.items()}
        assert got == JS.tree_join_count(frames, join_infos), trial
        assert got == _merge_count(frames, join_infos), trial
        assert got == S._merge_count({t: Table(d) for t, d in data.items()},
                                     join_infos), trial


def test_tree_join_count_rejects_cycles_and_disconnects():
    a = Table({"k": np.array([0, 1]), "m": np.array([0, 0])})
    b = Table({"k": np.array([0, 1]), "m": np.array([0, 1])})
    assert S.tree_join_count({0: a, 1: b},
                             [_JI(0, 1, "k"), _JI(0, 1, "m")]) is None
    c = Table({"z": np.array([1.0])})
    assert S.tree_join_count({0: a, 1: b, 2: c}, [_JI(0, 1, "k")]) is None
    with pytest.raises(ValueError, match="disconnected"):
        S._merge_count({0: a, 1: b, 2: c}, [_JI(0, 1, "k"), _JI(2, 2, "z")])


def test_tree_join_count_exact_beyond_float53():
    """Star on one shared key: count = n^4 = 2^56 > 2^53 takes the
    arbitrary-precision recompute; exact, and the JAX count."""
    n = 2 ** 14
    tables = {0: {"k": np.array([7])},
              **{t: {"k": np.full(n, 7)} for t in (1, 2, 3, 4)}}
    jis = [_JI(0, t, "k") for t in (1, 2, 3, 4)]
    got = S.tree_join_count({t: Table(c) for t, c in tables.items()}, jis)
    assert got == n ** 4
    assert got == JS.tree_join_count(
        {t: pd.DataFrame(c) for t, c in tables.items()}, jis)


def test_count_pairs_and_compare_are_the_jax_ones():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 20, 300).astype(float)
    b = rng.integers(0, 20, 200)
    for op in NUMERICAL_JOIN_OPS:
        assert S._count_pairs_op(a, b, op) == JS._count_pairs_op(a, b, op)
        np.testing.assert_array_equal(S._compare(a[:, None], b[None], op),
                                      JS._compare(a[:, None], b[None], op))
    with pytest.raises(ValueError):
        S._count_pairs_op(a, b, "~")
    with pytest.raises(RuntimeError, match="clickhouse_driver"):
        S.query_true_card_by_clickhouse("a@@a,a,k")


@pytest.mark.parametrize("a", [1.1, 1.25, 1.5, 2.2])
def test_chip_smoke_zipf_is_numpy_2_0_zipf(a):
    """The copies' Zipf draws: numpy 2.0's values, and the generator left
    where numpy 2.0 leaves it (this environment's numpy is 2.0)."""
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(chip_smoke._zipf(r1, a, 5000),
                                  r2.zipf(a, 5000))
    assert r1.random() == r2.random()


@pytest.mark.parametrize("family", ["tpch", "tpcds"])
def test_chip_smoke_table_copies_write_the_generators_bytes(tmp_path, family):
    gen, copy = {"tpch": (make_synthtpch, chip_smoke.tpch_tables),
                 "tpcds": (make_synthtpcds, chip_smoke.tpcds_tables)}[family]
    gen.write_csvs(gen.build_tables(scale=0.05), str(tmp_path / "gen"))
    chip_smoke.write_csvs(copy(scale=0.05), str(tmp_path / "copy"))
    names = sorted(os.listdir(tmp_path / "gen"))
    assert names == sorted(os.listdir(tmp_path / "copy"))
    for name in names:
        assert filecmp.cmp(tmp_path / "gen" / name, tmp_path / "copy" / name,
                           shallow=False), name


def test_synthtpch_regenerated_from_the_copied_tables_is_the_jax_output(
        tmp_path):
    """`make_synthtpch.main` at scale 0.03, 6 queries per arity, against
    the port's loaders, DBSchema and sampler (one process per arity) on
    chip_smoke's copied tables: every stats JSON and query file
    identical."""
    from nngp_tpu_torch.data.loaders import load_schema
    from nngp_tpu_torch.featurize.schema import DBSchema

    make_synthtpch.main(per_arity=6, scale=0.03,
                        out_name=str(tmp_path / "jax" / "data"),
                        stats_name=str(tmp_path / "jax" / "stats"),
                        csv_name=str(tmp_path / "jax_csv"))
    csv_dir = str(tmp_path / "copy_csv")
    chip_smoke.write_csvs(chip_smoke.tpch_tables(scale=0.03), csv_dir)
    tables, col_types, pks, names = load_schema("tpch", csv_dir)
    schema = DBSchema(tables, col_types, names, pks, chunk_size=64)
    os.makedirs(tmp_path / "port" / "stats")
    for i, st in enumerate(schema.stats):
        st.save(str(tmp_path / "port" / "stats" / f"{i}_{st.table_name}.json"))
    sampler = S.MultiJoinSampler(schema.dfs, schema.stats, seed=61)
    for p in sampler.parallel_sampler(6, str(tmp_path / "port" / "data"),
                                      data_centric=True):
        p.join()
        assert p.exitcode == 0
    for sub in ("stats", "data"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == 4
        for name in names:
            assert filecmp.cmp(tmp_path / "jax" / sub / name,
                               tmp_path / "port" / sub / name,
                               shallow=False), (sub, name)
