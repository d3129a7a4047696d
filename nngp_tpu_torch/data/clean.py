"""Offline schema cleaning: recode keys/categoricals and rewrite CSVs.

A copy of `nngp_tpu/data/clean.py` on the port's pandas-free `Table`
(`nngp_tpu_torch.data.table`), with the pandas calls it makes rebuilt
there: `pd.Categorical` codes, `Series.map` through a PK's code dict (a
miss turns the column float64), `fillna(-1)`, `astype(int)` and `to_csv`
(`;`, no index, floats printed as pandas prints them). The CSV bytes equal
the original's (`tests/test_torch_loaders.py`).

Parity surface of `schema_cleaning` (`reference/schemas.py:8-39`):
  1. each table's primary-key column -> categorical codes;
  2. every foreign-key column (same name as another table's PK) mapped
     through that PK's code dict, so join keys share an encoding space;
  3. remaining non-key categorical columns -> per-column categorical codes;
  4. NaNs filled with -1, integer cast, rewritten as `;`-separated CSVs.
"""

import os
from typing import Dict, List, Optional, Sequence

from nngp_tpu_torch.data.table import (Table, categorical, map_codes,
                                       write_csv)


def clean_schema(
    df_list: Sequence[Table],
    col_types_list: Sequence[Sequence[str]],
    table_names: Sequence[str],
    primary_keys: Sequence[str],
    out_dir: Optional[str] = None,
    cast_int: bool = False,
) -> List[Table]:
    """Returns the cleaned tables; writes `<out_dir>/<name>.csv` (sep=';',
    no index) when out_dir is given. Input tables are not mutated.

    cast_int: the reference's trailing `astype(int)` (`schemas.py:35-39`)
    is IMDB-specific (all-integer tables); applying it everywhere would
    truncate float columns (e.g. yelp latitude/longitude), so it is
    opt-in here."""
    dfs = [df.copy() for df in df_list]

    # PK columns -> categorical codes (`schemas.py:11-19`).
    pk_code_dicts: List[Dict] = []
    for df, pk in zip(dfs, primary_keys):
        if not pk:  # empty string denotes no primary key
            pk_code_dicts.append({})
            continue
        cats, codes = categorical(df[pk])
        pk_code_dicts.append({cat: code for code, cat in enumerate(cats)})
        df[pk] = codes

    # FK columns reuse their PK's codes (`schemas.py:21-29`).
    for t1, pk in enumerate(primary_keys):
        if not pk:
            continue
        for t2, df in enumerate(dfs):
            if t1 == t2:
                continue
            if pk in df.columns:
                df[pk] = map_codes(df[pk], pk_code_dicts[t1])

    # Non-key categorical columns -> per-column codes (`schemas.py:31-34`).
    for df, col_types in zip(dfs, col_types_list):
        for col_idx, col_name in enumerate(df.columns):
            if (col_types[col_idx] == "categorical"
                    and col_name not in list(primary_keys)):
                df[col_name] = categorical(df[col_name])[1]

    # NaN -> -1, int cast, CSV rewrite (`schemas.py:35-39`).
    cleaned = []
    for i, df in enumerate(dfs):
        df = df.fillna(-1)
        if cast_int:
            df = df.astype_int()
        cleaned.append(df)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            write_csv(df, os.path.join(out_dir, f"{table_names[i]}.csv"),
                      sep=";")
    return cleaned
