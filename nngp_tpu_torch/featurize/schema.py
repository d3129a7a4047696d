"""Multi-table schema assembly: PK/FK categorical recoding.

A copy of `nngp_tpu/featurize/schema.py` on the port's pandas-free `Table`
(`nngp_tpu_torch.data.table`): primary-key columns are mapped to
categorical codes as `pd.Categorical` maps them (`data.table.categorical`),
and every foreign-key column that references them is mapped through the
*same* code dict, so join keys share an encoding space across tables
(`reference/schemas.py:43-71`). Output is a list of `TableStats` plus the
recoded tables for ground-truth query execution by the offline sampler.
"""

from typing import Dict, List, Sequence

from nngp_tpu_torch.featurize.stats import TableStats


class DBSchema:
    def __init__(self, df_list: Sequence, col_types_list: Sequence,
                 table_names: Sequence[str], primary_keys: Sequence[str],
                 chunk_size: int = 64):
        from nngp_tpu_torch.data.table import categorical

        self.table_names = list(table_names)
        self.primary_keys = list(primary_keys)
        self.pk_code_dicts: List[Dict] = []

        # PK columns -> categorical codes (`schemas.py:48-55`). Work on
        # copies: recoding the caller's tables in place would silently
        # break any later use of them (e.g. running a sampler for ground
        # truth: PK codes joined against raw FK values return ~zero
        # cardinalities). `clean_schema` keeps the same no-mutation
        # contract.
        df_list = [df.copy() for df in df_list]
        for df, pk in zip(df_list, primary_keys):
            if not pk:
                self.pk_code_dicts.append({})
                continue
            cats, codes = categorical(df[pk])
            self.pk_code_dicts.append({cat: code
                                       for code, cat in enumerate(cats)})
            df[pk] = codes

        # FK columns reuse their PK's codes (`schemas.py:57-67`).
        self.fk_code_dicts_list: List[Dict[str, Dict]] = []
        for t2, df in enumerate(df_list):
            fk_code_dicts = {}
            for t1, key in enumerate(primary_keys):
                if t1 == t2 or not key:
                    continue
                if key in df.columns:
                    fk_code_dicts[key] = self.pk_code_dicts[t1]
            self.fk_code_dicts_list.append(fk_code_dicts)

        self.dfs = list(df_list)
        self.stats: List[TableStats] = [
            TableStats.from_dataframe(df, col_types, name,
                                      chunk_size=chunk_size, fk_code_dicts=fk)
            for df, col_types, name, fk in zip(
                df_list, col_types_list, table_names, self.fk_code_dicts_list)
        ]

    def print_schema_info(self, printer=print):
        printer("<" * 80)
        for t_id, st in enumerate(self.stats):
            printer(f"Table {t_id}: {st.table_name}")
            printer(f"Columns {[c.name for c in st.columns]}")
            printer(f"PK name: {self.primary_keys[t_id]}")
        printer(">" * 80)
