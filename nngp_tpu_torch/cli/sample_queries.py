"""Offline query-set generation CLI: the counterpart of
`nngp_tpu/cli/sample_queries.py`, without pandas. Same flags and the same
query files as the JAX CLI (`tests/test_torch_data_cli.py`); it runs on
the host and touches no device.

    # single table
    python -m nngp_tpu_torch.cli.sample_queries --relations forest \\
        --data_path /data/UCI --mini_batch 2000 --cat_size 100

    # multi-join schema
    python -m nngp_tpu_torch.cli.sample_queries --schema_name imdb_simple \\
        --data_path /data/imdb_clean --mini_batch 3000 --data_centric
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        "nngp_tpu_torch query sampler",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--relations", type=str, default=None,
                   help="single-table dataset (forest/higgs/sales/...)")
    p.add_argument("--names", type=str, default=None)
    p.add_argument("--schema_name", type=str, default=None,
                   help="multi-table schema (tpch/tpcds/imdb_simple/...)")
    p.add_argument("--binary", action="store_true",
                   help="two comma-separated --relations: sample binary "
                        "joins with the full op set (<,>,=,<=,>=,<>)")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--save_path", type=str, default="./queryset")
    p.add_argument("--mini_batch", type=int, default=2000)
    p.add_argument("--cat_size", type=int, default=10)
    p.add_argument("--chunk_size", type=int, default=64)
    p.add_argument("--data_centric", action="store_true")
    p.add_argument("--nrows", type=int, default=None)
    p.add_argument("--serial", action="store_true",
                   help="sample arities serially instead of one process each")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.relations is None) == (args.schema_name is None):
        raise SystemExit("pass exactly one of --relations / --schema_name")

    from nngp_tpu_torch.data.loaders import load_schema, load_table
    from nngp_tpu_torch.data.sampler import (BinaryJoinSampler,
                                             MultiJoinSampler,
                                             SingleTableSampler)
    from nngp_tpu_torch.featurize.schema import DBSchema
    from nngp_tpu_torch.featurize.stats import TableStats

    if args.binary:
        rels = [r.strip() for r in args.relations.split(",")]
        nms = ([n.strip() for n in args.names.split(",")]
               if args.names else rels)
        if len(rels) != 2:
            raise SystemExit("--binary needs exactly two --relations")
        dfs, sts = [], []
        for rel, nm in zip(rels, nms):
            df, col_types = load_table(rel, args.data_path, nrows=args.nrows)
            dfs.append(df)
            sts.append(TableStats.from_dataframe(df, col_types, nm,
                                                 chunk_size=args.chunk_size))
        sampler = BinaryJoinSampler(dfs[0], sts[0], dfs[1], sts[1])
        if sampler.encoder.total_num_joins == 0:
            raise SystemExit(
                f"tables {nms[0]!r} and {nms[1]!r} share no joinable column "
                "(same name + same kind) — nothing to sample")
        for nj in range(1, sampler.encoder.total_num_joins + 1):
            sampler.sample_batch_query(nj, args.mini_batch, args.cat_size,
                                       args.save_path, args.data_centric)
        print(f"wrote query files to {args.save_path}")
        return

    if args.relations:
        name = args.names or args.relations
        df, col_types = load_table(args.relations, args.data_path,
                                   nrows=args.nrows)
        stats = TableStats.from_dataframe(df, col_types, name,
                                          chunk_size=args.chunk_size)
        sampler = SingleTableSampler(df, stats)
        if args.serial:
            for d in range(1, stats.num_cols + 1):
                sampler.sample_batch_query(d, args.mini_batch, args.cat_size,
                                           args.save_path, args.data_centric)
        else:
            for p in sampler.parallel_sample(args.mini_batch, args.cat_size,
                                             args.save_path,
                                             args.data_centric):
                p.join()
    else:
        dfs, col_types_list, pks, table_names = load_schema(
            args.schema_name, args.data_path, nrows=args.nrows)
        schema = DBSchema(dfs, col_types_list, table_names, pks,
                          args.chunk_size)
        sampler = MultiJoinSampler(schema.dfs, schema.stats)
        if args.serial:
            for k in range(1, len(table_names) + 1):
                sampler.sample_batch_query(args.save_path, k, args.mini_batch,
                                           args.data_centric, args.cat_size)
        else:
            for p in sampler.parallel_sampler(args.mini_batch, args.save_path,
                                              args.data_centric,
                                              args.cat_size):
                p.join()
    print(f"wrote query files to {args.save_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
