"""Offline schema-cleaning CLI: the counterpart of
`nngp_tpu/cli/clean_schema.py`, without pandas. Load a multi-table
schema's raw CSVs, recode PK/FK/categorical columns to shared integer
codes, and rewrite cleaned `;`-separated CSVs, byte for byte as the JAX
CLI writes them (`tests/test_torch_data_cli.py`). It runs on the host.

    python -m nngp_tpu_torch.cli.clean_schema --schema_name imdb_simple \\
        --data_path /data/imdb_raw --out_dir /data/imdb_clean
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch schema cleaner",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--schema_name", type=str, required=True,
                   help="schema from loaders.SCHEMAS (tpch/tpcds/imdb_simple/...)")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--nrows", type=int, default=None)
    p.add_argument("--int_cast", action="store_true",
                   help="apply the reference's trailing astype(int) "
                        "(IMDB-specific: truncates float columns)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from nngp_tpu_torch.data.clean import clean_schema
    from nngp_tpu_torch.data.loaders import load_schema

    dfs, col_types_list, pks, table_names = load_schema(
        args.schema_name, args.data_path, nrows=args.nrows)
    clean_schema(dfs, col_types_list, table_names, pks, out_dir=args.out_dir,
                 cast_int=args.int_cast)
    print(f"wrote {len(dfs)} cleaned tables to {args.out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
