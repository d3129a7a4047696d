"""Table statistics + feature address layout.

A copy of `nngp_tpu/featurize/stats.py`. `TableStats.from_dataframe` takes
the port's pandas-free `Table` (`nngp_tpu_torch.data.table`) where the
original takes a DataFrame, and takes its categories the way
`pd.Categorical` does (`data.table.categorical`). Otherwise the code
differs only in its imports: the port imports nothing of the JAX package.
`tests/test_torch_featurize.py` and `tests/test_torch_loaders.py` hold the
copy to the original.

One featurization library replacing the reference's three copies of the same
logic (`reference/QuerySampler.py:24-56`,
`reference/JoinQuerySampler.py:33-68`,
`reference/neuroestimator/estimator/encoder.py:19-56`). A `TableStats`
is the minimal, serializable state the encoder needs — column kinds,
numerical ranges, categorical code dicts, and the derived feature-address
layout:

  numerical column   -> 2 slots (upper at start, lower at start+1), values
                        scaled to [0, 1000] by (v - min) / denom * 1000
  categorical column -> ceil(num_cat / chunk_size) slots of factorized
                        bit-packed chunks (chunk c, bit b) for code
                        c * chunk_size + b, bit value 2^(chunk_size - 1 - b)
                        (matches int(code_str, 2) at
                        `reference/QuerySampler.py:224-235`)

Stats can come from the raw CSV (exact reference parity), from a JSON
artifact (fast server start, no CSV on the serving host), or be estimated by
scanning the committed query files when the CSV is not shipped (the
`Queries/forest_data` fixtures embed data-centric constants whose min/max
converge to the true column ranges).

The denominator carries the reference `Table`'s 1e-6 floor for constant
columns (`reference/JoinQuerySampler.py:63-66`). The reference's
`GeneralQuerySampler` lacks that floor and would emit inf — a quirk, not a
feature (SURVEY.md section 5), so the floor is applied everywhere here.
"""

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Address = dataclasses.make_dataclass("Address", ["start", "end"], frozen=True)

NUMERICAL = "numerical"
CATEGORICAL = "categorical"


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    name: str
    kind: str                        # 'numerical' | 'categorical'
    min: float = 0.0                 # numerical only
    max: float = 0.0                 # numerical only
    categories: Optional[Tuple] = None  # categorical only: category -> code by position

    @property
    def denominator(self) -> float:
        d = self.max - self.min
        return d if d > 0 else 1e-6

    @property
    def num_cat(self) -> int:
        return len(self.categories) if self.categories is not None else 0

    @property
    def _code_index(self):
        # cached {category: code}: tuple.index is O(num_cat) per lookup,
        # quadratic for samplers over high-cardinality id columns (the
        # reference keeps a dict, `JoinQuerySampler.py:56`)
        d = self.__dict__.get("_code_index_cache")
        if d is None:
            d = {c: i for i, c in enumerate(self.categories or ())}
            object.__setattr__(self, "_code_index_cache", d)
        return d

    def code_of(self, category) -> int:
        return self._code_index[category]


@dataclasses.dataclass(frozen=True)
class TableStats:
    table_name: str
    columns: Tuple[ColumnStats, ...]
    chunk_size: int = 64
    num_rows: int = 0

    def __post_init__(self):
        addresses: List[Address] = []
        dim = 0
        for col in self.columns:
            if col.kind == CATEGORICAL:
                width = math.ceil(col.num_cat / self.chunk_size)
            else:
                width = 2
            addresses.append(Address(dim, dim + width))
            dim += width
        object.__setattr__(self, "_addresses", tuple(addresses))
        object.__setattr__(self, "_feat_dim", dim)
        object.__setattr__(
            self, "_col_index", {c.name: i for i, c in enumerate(self.columns)}
        )

    @property
    def addresses(self) -> Tuple[Address, ...]:
        return self._addresses

    @property
    def feat_dim(self) -> int:
        return self._feat_dim

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def col_idx(self, name: str) -> int:
        return self._col_index[name]

    def default_row(self) -> np.ndarray:
        """Feature row of an all-unconstrained query: numerical lower slot is
        1000, everything else 0 (`reference/QuerySampler.py:200-204`)."""
        x = np.zeros(self.feat_dim, dtype=np.float64)
        for col, addr in zip(self.columns, self.addresses):
            if col.kind == NUMERICAL:
                x[addr.start + 1] = 1000.0
        return x

    def scale_numeric(self, col_idx: int, value) -> float:
        col = self.columns[col_idx]
        return (value - col.min) / col.denominator * 1000.0

    # ------------------------------------------------------------ builders
    @classmethod
    def from_dataframe(cls, df, col_types: Sequence[str], table_name: str,
                       chunk_size: int = 64,
                       fk_code_dicts: Optional[Dict[str, Dict]] = None
                       ) -> "TableStats":
        """Exact reference semantics incl. NaN -> -1 fill before stats
        (`reference/JoinQuerySampler.py:35,42-68`) and FK columns reusing
        their PK's code dict (`:52-56`). `df` is a `data.table.Table`."""
        from nngp_tpu_torch.data.table import categorical

        df = df.fillna(-1)
        cols = []
        for i, name in enumerate(df.columns):
            series = df[name]
            if col_types[i] == CATEGORICAL:
                if fk_code_dicts and name in fk_code_dicts:
                    code_dict = fk_code_dicts[name]
                    cats = tuple(sorted(code_dict, key=code_dict.get))
                else:
                    # pd.Categorical's categories, like the reference
                    # (`JoinQuerySampler.py:49`), also on mixed-type object
                    # columns (string ids whose NaNs the fill above turned
                    # into int -1: numbers sort before strings)
                    cats = tuple(categorical(series)[0])
                cols.append(ColumnStats(name=name, kind=CATEGORICAL, categories=cats))
            else:
                cols.append(ColumnStats(
                    name=name, kind=NUMERICAL,
                    min=float(np.min(series)), max=float(np.max(series)),
                ))
        return cls(table_name=table_name, columns=tuple(cols),
                   chunk_size=chunk_size, num_rows=len(df))

    @classmethod
    def from_query_files(cls, query_path: str, col_names: Sequence[str],
                         table_name: str, chunk_size: int = 64) -> "TableStats":
        """Estimate numerical ranges by scanning query-file constants — the
        CSV-less fallback for the committed fixtures
        (`reference/Queries/forest_data`, grammar
        `col,upper,lower#...@card`)."""
        mins = {c: np.inf for c in col_names}
        maxs = {c: -np.inf for c in col_names}
        for fname in sorted(os.listdir(query_path)):
            with open(os.path.join(query_path, fname)) as f:
                for line in f:
                    body = line.strip().split("@")[0]
                    if not body:
                        continue
                    for pred in body.split("#"):
                        parts = pred.split(",")
                        name = parts[0].strip()
                        if name not in mins:
                            continue
                        hi, lo = float(parts[1]), float(parts[2])
                        if lo < mins[name]:
                            mins[name] = lo
                        if hi > maxs[name]:
                            maxs[name] = hi
        cols = tuple(
            ColumnStats(name=c, kind=NUMERICAL, min=float(mins[c]), max=float(maxs[c]))
            for c in col_names
        )
        return cls(table_name=table_name, columns=cols, chunk_size=chunk_size)

    # ---------------------------------------------------------------- io
    def to_json(self) -> str:
        payload = {
            "table_name": self.table_name,
            "chunk_size": self.chunk_size,
            "num_rows": self.num_rows,
            "columns": [
                {
                    "name": c.name,
                    "kind": c.kind,
                    "min": c.min,
                    "max": c.max,
                    "categories": list(c.categories) if c.categories is not None else None,
                }
                for c in self.columns
            ],
        }
        return json.dumps(payload, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TableStats":
        payload = json.loads(text)
        cols = tuple(
            ColumnStats(
                name=c["name"], kind=c["kind"], min=c["min"], max=c["max"],
                categories=tuple(c["categories"]) if c["categories"] is not None else None,
            )
            for c in payload["columns"]
        )
        return cls(
            table_name=payload["table_name"], columns=cols,
            chunk_size=payload["chunk_size"], num_rows=payload.get("num_rows", 0),
        )

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TableStats":
        with open(path) as f:
            return cls.from_json(f.read())


def load_stats_dir(stats_dir: str, table_names=None):
    """Load every TableStats JSON in a directory, ORDERED.

    The order defines the feature layout (per-table blocks + join-triple
    vocabulary), so it must match the order the model was trained with.
    Pass `table_names` (e.g. from `data.loaders.SCHEMAS[name][1]`) to order
    by schema; without it, files are ordered by sorted filename — fine for
    the committed `NN_<table>.json` convention, but a plain `<table>.json`
    dir would silently permute the layout relative to the CSV path.
    Non-JSON files are ignored."""
    import os

    stats = [TableStats.load(os.path.join(stats_dir, f))
             for f in sorted(os.listdir(stats_dir)) if f.endswith(".json")]
    if table_names is not None:
        by_name = {t.table_name: t for t in stats}
        missing = [n for n in table_names if n not in by_name]
        if missing:
            raise FileNotFoundError(
                f"stats dir {stats_dir} lacks tables {missing} "
                f"(has {sorted(by_name)})")
        stats = [by_name[n] for n in table_names]
    return stats
