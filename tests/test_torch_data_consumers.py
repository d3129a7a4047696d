"""Every surface of the port that builds table stats from raw CSVs, against
the JAX package on the same tiny tables (`tests/test_torch_data_cli.py`'s
fixtures): the workload loaders' X and Y, `Estimator(data_path=...)`, the
active-learning CLI's binary-join path, the serving demo's --data_path,
and the baseline CLIs' --data_path."""

import numpy as np
import pytest

from nngp_tpu.cli import active_train as j_active
from nngp_tpu.data.workload import load_binary_join_workload as j_binary
from nngp_tpu.data.workload import load_multi_join_workload as j_multi
from nngp_tpu.data.workload import load_single_table_workload as j_single
from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.cli import (active_train, serve_demo, train_baselines,
                                train_multijoin)
from nngp_tpu_torch.data.workload import (load_binary_join_workload,
                                          load_multi_join_workload,
                                          load_single_table_workload)
from nngp_tpu_torch.serve import Estimator
from tests.test_torch_data_cli import labeled, raw  # noqa: F401 (fixtures)


def _same(got, want):
    x, y, infos, enc = got
    jx, jy, jinfos, jenc = want
    assert x.dtype == jx.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert [tuple(i) for i in infos] == [tuple(i) for i in jinfos]
    return enc, jenc


@pytest.mark.parametrize("chunk_norm", [False, True])
def test_multi_join_workload_from_csvs_is_the_jax_one(raw, labeled,
                                                      chunk_norm):
    args = dict(schema_name="tpch", data_path=str(raw / "tpch"),
                chunk_size=16, chunk_norm=chunk_norm)
    enc, jenc = _same(load_multi_join_workload(str(labeled / "tpch"), **args),
                      j_multi(str(labeled / "tpch"), **args))
    assert [t.to_json() for t in enc.tables] == \
        [t.to_json() for t in jenc.tables]


def test_binary_join_workload_is_the_jax_one(raw, labeled):
    args = dict(relations="yelp-review,yelp-user", names="review,user",
                data_path=str(raw / "single"))
    enc, jenc = _same(load_binary_join_workload(str(labeled / "binary"),
                                                **args),
                      j_binary(str(labeled / "binary"), **args))
    assert enc.total_num_joins == jenc.total_num_joins == 4
    with pytest.raises(ValueError, match="stats_pair"):
        load_binary_join_workload(str(labeled / "binary"))


def test_single_table_workload_from_a_csv_is_the_jax_one(raw, labeled,
                                                         tmp_path):
    args = dict(relation="forest", name="forest", data_path=str(raw /
                                                                "single"))
    enc, jenc = _same(load_single_table_workload(str(labeled / "forest"),
                                                 **args),
                      j_single(str(labeled / "forest"), **args))
    assert enc.stats.to_json() == jenc.stats.to_json()
    assert enc.stats.num_rows == 240
    # no CSV there: the silent fall-back to the query scan, as in JAX
    args["data_path"] = str(tmp_path)
    _same(load_single_table_workload(str(labeled / "forest"), **args),
          j_single(str(labeled / "forest"), **args))


def test_estimator_builds_its_stats_from_the_csvs(raw, labeled):
    """Estimator(data_path=...) without stats: the schema's stats from
    its CSVs, and the JAX Estimator's predictions (fp64)."""
    lines = [l.rsplit("@", 1)[0] for l in
             open(labeled / "tpch" / "join_query_3.txt").read().split()[:12]]
    est = Estimator("tpch", str(raw / "tpch"), str(labeled / "tpch"),
                    dtype=np.float64, verbose=False, device="cpu")
    jest = JaxEstimator("tpch", str(raw / "tpch"), str(labeled / "tpch"),
                        dtype=np.float64, verbose=False)
    assert [t.to_json() for t in est.stats] == \
        [t.to_json() for t in jest.stats]
    mean, std = est.predict(lines)
    jmean, jstd = jest.predict(lines)
    np.testing.assert_allclose(mean, jmean, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(std, jstd, rtol=1e-6, atol=1e-9)


def test_active_train_binary_join_matches_jax(raw, labeled, capsys):
    argv = ["--x64", "--relations", "yelp-review,yelp-user",
            "--names", "review,user", "--data_path", str(raw / "single"),
            "--query_path", str(labeled / "binary"), "--budget", "20",
            "--active_iters", "1", "--selection", "topk"]
    want = j_active.main(argv)
    jax_out = capsys.readouterr().out
    got = active_train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)
    for prefix in ("number of query", "train (", "# "):
        assert [l for l in out.splitlines() if l.startswith(prefix)] == \
            [l for l in jax_out.splitlines() if l.startswith(prefix)]


def test_serve_demo_takes_the_stats_from_the_csvs(raw, labeled, capsys):
    serve_demo.main(["--device", "cpu", "--schema_name", "tpch",
                     "--data_path", str(raw / "tpch"),
                     "--train_query_path", str(labeled / "tpch"),
                     "--test_query_file",
                     str(labeled / "tpch" / "join_query_2.txt"),
                     "--limit", "20"])
    assert "predicted 20 queries" in capsys.readouterr().out


def test_baseline_clis_take_the_stats_from_the_csvs(raw, labeled, capsys):
    """train_baselines (a dense model and MSCN) through
    `single_table_stats`' CSV branch; train_multijoin through DBSchema."""
    from nngp_tpu.featurize.schema import DBSchema as JDBSchema
    from nngp_tpu.data.loaders import SCHEMAS

    small = ["--device", "cpu", "--query_path", str(labeled / "forest"),
             "--data_path", str(raw / "single"), "--epochs", "1",
             "--num_hid", "8"]
    for model in ("DNN", "MSCN"):
        train_baselines.main(["--model_type", model, *small])
        out = capsys.readouterr().out
        assert "mean square error: " in out
    args = train_multijoin.build_parser().parse_args(
        ["--query_path", str(labeled / "tpch"), "--schema_name", "tpch",
         "--data_path", str(raw / "tpch")])
    stats = train_multijoin._load_stats(args)
    dfs, cts, pks = zip(*[fn(str(raw / "tpch"))
                          for fn in SCHEMAS["tpch"][0]])
    jstats = JDBSchema(dfs, cts, SCHEMAS["tpch"][1], pks, 10).stats
    assert [t.to_json() for t in stats] == [t.to_json() for t in jstats]
    train_multijoin.main(["--device", "cpu", "--model_type", "MSCN",
                          "--query_path", str(labeled / "tpch"),
                          "--schema_name", "tpch", "--data_path",
                          str(raw / "tpch"), "--epochs", "1"])
    assert "MSCN mean square error: " in capsys.readouterr().out
