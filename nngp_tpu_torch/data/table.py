"""`Table`: the port's small column table, and the parts of pandas the
data layer leans on, rebuilt on the standard library's `csv` and numpy.

The JAX package's data layer (`nngp_tpu/data/`, `nngp_tpu/featurize/
schema.py`, `TableStats.from_dataframe`) runs on pandas DataFrames. The
port has no pandas, so the loaders return a `Table` (ordered column name
-> 1-D numpy array), and these functions reproduce the pandas semantics
that decide the bytes the data layer writes:

  read_csv     `pd.read_csv`'s type inference (an int64 column only when
               every field is an integer literal and none is missing; a
               missing field makes the column float64 with NaN; other text
               makes it an object column of str), its default NA tokens,
               `header=0` with `names` replacing the file's header,
               `header=None`, positional `usecols`, `nrows`, blank lines
               skipped, and leading surplus fields taken as the index
               (dropped here: nothing downstream reads it);
  fillna       `DataFrame.fillna(-1)`: float NaN -> -1.0, an object
               column's NaN -> the int -1, other dtypes untouched;
  categorical  `pd.Categorical(values)`: categories are the sorted unique
               non-NA values (numbers before strings when they mix, as
               pandas' `_sort_mixed` orders them), codes take the smallest
               signed int dtype that holds them, -1 marks NA;
  map_codes    `Series.map(dict)`: a miss is NaN, so the column turns
               float64;
  write_csv    `DataFrame.to_csv(sep=..., index=False)`: floats printed as
               numpy prints them (`3.0`), NaN as the empty field.

`tests/test_torch_loaders.py` holds each to pandas.
"""

import csv
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# pandas' default NA tokens (`pandas._libs.parsers.STR_NA_VALUES`)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"\s*[+-]?[0-9]+\s*\Z")
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_I64 = np.iinfo(np.int64)
_INT_CHARS = frozenset("0123456789+- \t")
_FLOAT_CHARS = frozenset("0123456789+-.eE \t")


class Table:
    """Ordered columns of equal length: column name -> 1-D numpy array.

    The port's stand-in for the pandas DataFrame the JAX package's data
    layer passes around: `columns`, `len`, `t[name]`, `t[name] = values`,
    `copy`, `fillna`, `astype_int` and `take` (a row selection by mask or
    index)."""

    def __init__(self, columns: Optional[Dict[str, Iterable]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in (columns or {}).items():
            self[name] = values

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        for values in self._cols.values():
            return len(values)
        return 0

    def __getitem__(self, name) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name, values):
        values = np.asarray(values)
        if values.ndim != 1:
            raise ValueError(f"column {name!r} must be 1-D, got "
                             f"shape {values.shape}")
        if self._cols and name not in self._cols and len(values) != len(self):
            raise ValueError(f"column {name!r} has {len(values)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = values

    def copy(self) -> "Table":
        return Table({n: v.copy() for n, v in self._cols.items()})

    def take(self, rows) -> "Table":
        """The rows a boolean mask or an index array selects."""
        return Table({n: v[rows] for n, v in self._cols.items()})

    def fillna(self, value) -> "Table":
        return Table({n: fillna(v, value) for n, v in self._cols.items()})

    def astype_int(self) -> "Table":
        """`DataFrame.astype(int)`: every column to int64."""
        return Table({n: np.asarray(v).astype(np.int64)
                      for n, v in self._cols.items()})


def isna(values: np.ndarray) -> np.ndarray:
    """pandas' NA mask: NaN in a float column, NaN or None in an object
    column, nothing elsewhere."""
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.fromiter((v is None or (isinstance(v, float) and v != v)
                            for v in values), bool, len(values))
    return np.zeros(len(values), bool)


def fillna(values: np.ndarray, value) -> np.ndarray:
    if values.dtype.kind not in "fO":
        return values
    na = isna(values)
    if not na.any():
        return values
    out = values.copy()
    out[na] = float(value) if values.dtype.kind == "f" else value
    return out


def _column(fields: Sequence[Optional[str]]) -> np.ndarray:
    """One parsed column as `pd.read_csv` types it; None is a missing
    field."""
    if not fields:
        return np.array([], object)
    na = [f is None or f in NA_VALUES for f in fields]
    present = [f for f, m in zip(fields, na) if not m]
    if not any(na) and _int_chars(fields) and all(map(_INT.match, fields)):
        ints = [int(f) for f in fields]
        if all(_I64.min <= v <= _I64.max for v in ints):
            return np.array(ints, np.int64)
        if all(0 <= v < 2 ** 64 for v in ints):
            return np.array(ints, np.uint64)
    floats = _floats(fields, na)
    if floats is not None:
        return floats
    if present and all(f in _TRUE or f in _FALSE for f in present):
        if not any(na):
            return np.array([f in _TRUE for f in fields], bool)
        return np.array([np.nan if m else f in _TRUE
                         for f, m in zip(fields, na)], object)
    out = np.empty(len(fields), object)
    out[:] = [np.nan if m else f for f, m in zip(fields, na)]
    return out


def _int_chars(fields) -> bool:
    return set("".join(fields)) <= _INT_CHARS


def _floats(fields, na) -> Optional[np.ndarray]:
    plain = [f for f, m in zip(fields, na) if not m]
    if set("".join(plain)) <= _FLOAT_CHARS:
        # plain decimal literals: numpy parses them as float() does
        try:
            return np.array(["nan" if m else f for f, m in zip(fields, na)],
                            dtype=np.float64)
        except ValueError:
            return None
    out = np.empty(len(fields), np.float64)
    for i, (f, m) in enumerate(zip(fields, na)):
        if m:
            out[i] = np.nan
            continue
        # Python's float() also takes '1_0' and 'NAN'; pandas reads both
        # as text
        if "_" in f or f.strip().lstrip("+-").lower().startswith("n"):
            return None
        try:
            out[i] = float(f)
        except ValueError:
            return None
    return out


def read_csv(path: str, names: Sequence[str], header: Optional[int] = 0,
             delimiter: str = ",", usecols: Optional[Sequence[int]] = None,
             nrows: Optional[int] = None) -> Table:
    """`pd.read_csv(path, header=header, delimiter=delimiter,
    usecols=usecols, names=names, nrows=nrows)` as a `Table`."""
    names = list(names)
    rows: List[List[str]] = []
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delimiter)
        seen_header = header is None
        for row in reader:
            if not row:
                continue          # blank line
            if not seen_header:
                seen_header = True   # the file's header; `names` replace it
                continue
            if nrows is not None and len(rows) >= nrows:
                break
            rows.append(row)
    width = len(rows[0]) if rows else len(names)
    if usecols is not None:
        picks = sorted(usecols)
        if picks and picks[-1] >= width:
            raise ValueError(f"{path}: usecols {list(usecols)} beyond the "
                             f"{width} fields of its first row")
        if len(picks) != len(names):
            raise ValueError(f"{path}: {len(names)} names for "
                             f"{len(picks)} usecols")
    else:
        # surplus leading fields become pandas' index (the movie_info_idx2
        # quirk, `nngp_tpu/data/loaders.py:150-158`)
        skip = max(width - len(names), 0)
        picks = [skip + j for j in range(len(names))]
        for line, row in enumerate(rows):
            if len(row) > skip + len(names):
                raise ValueError(f"{path}: expected {skip + len(names)} "
                                 f"fields in data row {line}, saw {len(row)}")
    return Table({
        name: _column([row[i] if i < len(row) else None for row in rows])
        for name, i in zip(names, picks)})


def _sort_mixed(values: list) -> list:
    """pandas' order for categories that will not sort together: numbers
    first, then strings, each sorted."""
    strs = [v for v in values if isinstance(v, str)]
    nums = [v for v in values if not isinstance(v, str)]
    return sorted(nums) + sorted(strs)


def _code_dtype(n: int):
    for dtype in (np.int8, np.int16, np.int32):
        if n < np.iinfo(dtype).max:
            return dtype
    return np.int64


def categorical(values: np.ndarray):
    """(categories, codes) of `pd.Categorical(values)`: categories a list
    of Python scalars, codes the smallest signed int dtype, -1 for NA."""
    values = np.asarray(values)
    na = isna(values)
    if values.dtype.kind == "O":
        uniq = list(dict.fromkeys(v for v, m in zip(values.tolist(), na)
                                  if not m))
        has_str = any(isinstance(v, str) for v in uniq)
        if has_str and any(isinstance(v, (int, np.integer))
                           and not isinstance(v, bool) for v in uniq):
            cats = _sort_mixed(uniq)
        else:
            try:
                cats = sorted(uniq)
            except TypeError:
                cats = _sort_mixed(uniq)
        index = {c: i for i, c in enumerate(cats)}
        codes = np.array([-1 if m else index[v]
                          for v, m in zip(values.tolist(), na)], np.int64)
    else:
        uniq, inv = np.unique(values[~na], return_inverse=True)
        cats = uniq.tolist()
        codes = np.full(len(values), -1, np.int64)
        codes[~na] = inv.ravel()
    return cats, codes.astype(_code_dtype(len(cats)))


def map_codes(values: np.ndarray, mapping: dict) -> np.ndarray:
    """`pd.Series(values).map(mapping)` for a dict of int codes: int64
    when every value is a key, else float64 with NaN at the misses."""
    na = isna(values)
    got = [None if m else mapping.get(v)
           for v, m in zip(values.tolist(), na)]
    if all(g is not None for g in got):
        return np.array(got, np.int64)
    return np.array([np.nan if g is None else g for g in got], np.float64)


def _csv_cells(values: np.ndarray) -> list:
    if values.dtype.kind == "f":
        cells = values.astype(str).astype(object)
        cells[np.isnan(values)] = ""
        return cells.tolist()
    if values.dtype.kind == "O":
        na = isna(values)
        return ["" if m else v for v, m in zip(values.tolist(), na)]
    return values.tolist()


def write_csv(table: Table, path: str, sep: str = ";"):
    """`DataFrame.to_csv(path, sep=sep, index=False)`."""
    cols = [_csv_cells(table[n]) for n in table.columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        w.writerow(table.columns)
        w.writerows(zip(*cols))
