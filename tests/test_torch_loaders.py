"""The port's pandas-free data layer against the JAX package's pandas one:
the 24 CSV loaders (`data/loaders.py`), the `Table` helpers that stand in
for pandas (`data/table.py`), `TableStats.from_dataframe`, `DBSchema`
(`featurize/schema.py`) and `clean_schema` (`data/clean.py`). Inputs are
tiny CSVs written from seeded numpy draws, with empty fields and text
columns; every comparison is exact: the same columns, dtypes and values,
the same stats JSON text, the same CSV bytes."""

import csv

import numpy as np
import pandas as pd
import pytest

import nngp_tpu.data.loaders as JL
from nngp_tpu.data.clean import clean_schema as j_clean_schema
from nngp_tpu.featurize.schema import DBSchema as JDBSchema
from nngp_tpu.featurize.stats import TableStats as JTableStats
from nngp_tpu_torch.data import loaders as L
from nngp_tpu_torch.data.clean import clean_schema
from nngp_tpu_torch.data.table import (Table, categorical, map_codes,
                                       read_csv, write_csv)
from nngp_tpu_torch.featurize.schema import DBSchema
from nngp_tpu_torch.featurize.stats import TableStats
from tests.test_loader_onramp import _make_schema_csvs

ALL_LOADERS = sorted(n for n in dir(JL) if n.startswith("load_")
                     and n != "load_table")
# loader -> (delimiter, header row?, fields per row) of its file
_LAYOUT = {"load_forest": (",", False, 55), "load_higgs": (",", False, 29),
           "load_sales": (",", True, 6)}


def _cells(values):
    """Comparable cells: NaN as a marker, numpy scalars as Python ones."""
    return [("NaN",) if isinstance(v, float) and v != v else (type(v), v)
            for v in np.asarray(values).tolist()]


def same_table(table: Table, df: pd.DataFrame):
    assert table.columns == list(df.columns)
    assert len(table) == len(df.index)
    for name in table.columns:
        want = df[name].to_numpy()
        got = table[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert _cells(got) == _cells(want), name


def _field(kind, rng, i):
    if kind == "int":
        return str(int(rng.integers(-50, 500)))
    if kind == "float":
        return f"{rng.uniform(-100, 100):.2f}"
    if kind == "int_gaps":
        return "" if i % 5 == 3 else str(int(rng.integers(0, 40)))
    if kind == "text":
        return "" if i % 6 == 2 else f"id{int(rng.integers(0, 9))}x"
    if kind == "exp":
        return f"{rng.uniform(0, 1):.3e}"
    raise AssertionError(kind)


def _write_loader_csv(path, delimiter, header, width, rows, seed):
    rng = np.random.default_rng(seed)
    kinds = [("int", "float", "int_gaps", "text", "exp")[int(k)]
             for k in rng.integers(0, 5, width)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=delimiter)
        if header:
            w.writerow([f"h{j}" for j in range(width)])
        for i in range(rows):
            w.writerow([_field(k, rng, i) for k in kinds])
            if i == 4:
                f.write("\n")        # a blank line: skipped
    return kinds


def _loader_file(tmp_path, name, seed=0, rows=23):
    filename = getattr(L, name).__defaults__[0]
    delimiter, header, width = _LAYOUT.get(name, (";", True, None))
    if width is None:
        # the loader's column count: pandas reads a header-only file as an
        # empty frame with the loader's names
        probe = tmp_path / "probe"
        probe.mkdir()
        (probe / filename).write_text("h0\n")
        width = len(getattr(JL, name)(str(probe))[0].columns)
    _write_loader_csv(tmp_path / filename, delimiter, header, width, rows,
                      seed)
    return str(tmp_path)


@pytest.mark.parametrize("name", ALL_LOADERS)
def test_every_loader_reads_what_pandas_reads(tmp_path, name):
    """All 24 loaders: columns, dtypes and values equal to the JAX
    loaders' DataFrames, whole files and with nrows, on files with
    integer, decimal, exponent, gappy and text columns and a blank line."""
    assert len(ALL_LOADERS) == 24
    path = _loader_file(tmp_path, name, seed=ALL_LOADERS.index(name))
    for nrows in (None, 7):
        got = getattr(L, name)(path, nrows=nrows)
        want = getattr(JL, name)(path, nrows=nrows)
        same_table(got[0], want[0])
        assert got[1:] == want[1:]


def test_movie_info_idx2_takes_field_0_as_the_index(tmp_path):
    """The quirk of `nngp_tpu/data/loaders.py:150-158`: a three-field file
    read with two names labels fields 1 and 2."""
    rows = [[10, 1, 5], [11, 2, 6], [12, 2, 7]]
    with open(tmp_path / "movie_info_idx.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["movie_info_idx_id", "movie_id", "info_type_id"])
        w.writerows(rows)
    got, _, pk = L.load_imdb_movie_info_idx2(str(tmp_path))
    want, _, _ = JL.load_imdb_movie_info_idx2(str(tmp_path))
    same_table(got, want)
    assert got["movie_info_idx_id"].tolist() == [1, 2, 2]
    assert got["movie_id"].tolist() == [5, 6, 7]
    assert pk == "movie_info_idx_id"


@pytest.mark.parametrize("fields", [
    [" 5", "+6", "7 "], ["1_000", "2"], ["inf", "-1"], ["Infinity", "1"],
    ["NAN", "1"], ["1e3", ".5", "5."], ["0x10", "2"], ["True", "false"],
    ["True", "1"], ["18446744073709551615", "1"], ["NA", "1"],
    ["None", "null", "2"], ["N/A", "x"], ["-nan", "3"], ["1.5e400", "1"],
    ["a;b", "c"], ['"5"', "6"], ["", "3", ""], ["True", "", "false"],
], ids=lambda f: "|".join(f))
def test_read_csv_types_fields_as_pandas(tmp_path, fields):
    path = tmp_path / "t.csv"
    with open(path, "w") as f:
        f.write("a,c\n" + "".join(f"{v},z\n" for v in fields))
    same_table(read_csv(str(path), ["a", "c"], header=0, delimiter=","),
               pd.read_csv(path, header=0, names=["a", "c"]))


def _object(values):
    out = np.empty(len(values), object)
    out[:] = values
    return out


@pytest.mark.parametrize("values", [
    np.array([3, 1, 2, 3, 1]),
    np.array([2.5, np.nan, 1.0, 2.5]),
    _object(["u3", "u1", np.nan, "u2"]),
    _object(["u3", "u1", -1, "u2", -1]),        # string ids after fillna
    _object([True, False, True]),
    np.arange(126), np.arange(127), np.arange(32766), np.arange(32767),
], ids=["int", "float-nan", "str-nan", "mixed", "bool", "126", "127",
        "32766", "32767"])
def test_categorical_is_pd_categorical(values):
    cats, codes = categorical(values)
    want = pd.Categorical(values)
    assert cats == want.categories.tolist()
    assert codes.dtype == want.codes.dtype
    np.testing.assert_array_equal(codes, want.codes)


@pytest.mark.parametrize("values", [
    np.array([0, 2, 1]), np.array([0, 5, 1]), np.array([0.0, np.nan, 2.0]),
    _object(["u2", "u1", np.nan]),
], ids=["hit", "miss", "nan", "str"])
def test_map_codes_is_series_map(values):
    mapping = {0: 0, 1: 1, 2: 2, "u1": 0, "u2": 1}
    got = map_codes(values, mapping)
    want = pd.Series(values).map(mapping).to_numpy()
    assert got.dtype == want.dtype
    assert _cells(got) == _cells(want)


def test_write_csv_bytes_are_to_csv_bytes(tmp_path):
    cols = {"i": np.array([3, -1, 12]), "f": np.array([3.0, 0.1, 1e20]),
            "g": np.array([1e-5, np.nan, 123456.789]),
            "s": _object(["a;b", np.nan, 'q"t']),
            "c": np.array([1, 0, 2], np.int8), "b": np.array([True, False,
                                                              True])}
    write_csv(Table(cols), str(tmp_path / "port.csv"))
    pd.DataFrame(cols).to_csv(tmp_path / "jax.csv", sep=";", index=False)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_fillna_is_dataframe_fillna():
    cols = {"f": np.array([1.0, np.nan]), "s": _object(["x", np.nan]),
            "i": np.array([1, 2])}
    got = Table(cols).fillna(-1)
    same_table(got, pd.DataFrame(cols).fillna(-1))
    assert type(got["s"][1]) is int


def _both_schema(schema_name, csv_dir):
    loaders, names = L.SCHEMAS[schema_name]
    tables, jdfs, col_types, pks = [], [], [], []
    for fn, jfn in zip(loaders, JL.SCHEMAS[schema_name][0]):
        t, ct, pk = fn(str(csv_dir))
        df, jct, jpk = jfn(str(csv_dir))
        assert (ct, pk) == (jct, jpk)
        tables.append(t)
        jdfs.append(df)
        col_types.append(ct)
        pks.append(pk)
    return tables, jdfs, col_types, pks, names


@pytest.mark.parametrize("schema_name", ["tpch", "tpcds", "yelp", "imdb"])
def test_db_schema_stats_and_pk_codes_are_the_jax_ones(tmp_path,
                                                       schema_name):
    _make_schema_csvs(schema_name, tmp_path)
    tables, jdfs, col_types, pks, names = _both_schema(schema_name, tmp_path)
    schema = DBSchema(tables, col_types, names, pks, chunk_size=16)
    jschema = JDBSchema(jdfs, col_types, names, pks, chunk_size=16)
    for st, jst in zip(schema.stats, jschema.stats):
        assert st.to_json() == jst.to_json()
    for t, df in zip(schema.dfs, jschema.dfs):
        same_table(t, df)
    assert schema.pk_code_dicts == jschema.pk_code_dicts
    assert schema.fk_code_dicts_list == jschema.fk_code_dicts_list
    # the caller's tables are not recoded
    for t, df in zip(tables, jdfs):
        same_table(t, df)


def _dirty_schema_csvs(d):
    """String PK and FK ids with gaps, a categorical text column, numeric
    gaps: the layout of `tests/test_clean.py`, one row more each."""
    with open(d / "users.csv", "w") as f:
        f.write("user_id;country;age\nu3;DE;33\nu1;FR;\nu2;;19\nu4;DE;41\n")
    with open(d / "orders.csv", "w") as f:
        f.write("order_id;user_id;amount\n10;u2;5.0\n11;u1;7.5\n12;u1;\n"
                "13;;2.0\n14;u9;1.25\n")
    names = ["user_id", "country", "age"], ["order_id", "user_id", "amount"]
    col_types = [["categorical", "categorical", "numerical"],
                 ["categorical", "categorical", "numerical"]]
    tables = [read_csv(str(d / f"{t}.csv"), n, delimiter=";")
              for t, n in zip(("users", "orders"), names)]
    jdfs = [pd.read_csv(d / f"{t}.csv", header=0, names=n, delimiter=";")
            for t, n in zip(("users", "orders"), names)]
    return tables, jdfs, col_types, ["users", "orders"], ["user_id",
                                                          "order_id"]


def test_fk_categories_and_mixed_text_stats_are_the_jax_ones(tmp_path):
    """An FK takes its categories from its PK's code dict; a text column
    whose NaN the fill turned into int -1 orders -1 before the strings, as
    pd.Categorical does (`nngp_tpu/featurize/stats.py:146-151`)."""
    tables, jdfs, col_types, names, pks = _dirty_schema_csvs(tmp_path)
    schema = DBSchema(tables, col_types, names, pks, chunk_size=2)
    jschema = JDBSchema(jdfs, col_types, names, pks, chunk_size=2)
    for st, jst in zip(schema.stats, jschema.stats):
        assert st.to_json() == jst.to_json()
    country = schema.stats[0].columns[1]
    assert country.categories == (-1, "DE", "FR")
    for t, ct, df in zip(tables, col_types, jdfs):
        assert TableStats.from_dataframe(t, ct, "x").to_json() == \
            JTableStats.from_dataframe(df, ct, "x").to_json()


@pytest.mark.parametrize("cast_int", [False, True])
@pytest.mark.parametrize("layout", ["dirty", "tpch", "imdb"])
def test_clean_schema_tables_and_csv_bytes_are_the_jax_ones(tmp_path, layout,
                                                            cast_int):
    csv_dir = tmp_path / "raw"
    csv_dir.mkdir()
    if layout == "dirty":
        tables, jdfs, col_types, names, pks = _dirty_schema_csvs(csv_dir)
    else:
        _make_schema_csvs(layout, csv_dir)
        tables, jdfs, col_types, pks, names = _both_schema(layout, csv_dir)
    got = clean_schema(tables, col_types, names, pks,
                       out_dir=str(tmp_path / "port"), cast_int=cast_int)
    want = j_clean_schema(jdfs, col_types, names, pks,
                          out_dir=str(tmp_path / "jax"), cast_int=cast_int)
    for t, df in zip(got, want):
        same_table(t, df)
    for name in names:
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == \
            (tmp_path / "jax" / f"{name}.csv").read_bytes()
    if layout == "dirty" and not cast_int:
        # the FK that misses its PK's dict turned float: -1.0, not -1
        assert got[1]["user_id"].tolist() == [1.0, 0.0, 0.0, -1.0, -1.0]


def test_schemas_and_loaders_registries_match():
    assert list(L.LOADERS) == list(JL.LOADERS)
    assert {k: v[1] for k, v in L.SCHEMAS.items()} == \
        {k: v[1] for k, v in JL.SCHEMAS.items()}
    for name, (fns, _tables) in L.SCHEMAS.items():
        assert [f.__name__ for f in fns] == \
            [f.__name__ for f in JL.SCHEMAS[name][0]]
    with pytest.raises(ValueError, match="Unsupported dataset"):
        L.load_table("nope", ".")
