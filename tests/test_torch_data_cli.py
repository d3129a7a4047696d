"""The port's offline data CLIs (`cli.sample_queries`, `cli.clean_schema`)
and the raw-CSV paths of its training CLI against the JAX package's CLIs on
the CPU: the same files byte for byte, and the same printed q-error from
`--data_path` (single-table, multi-join) and `--relations a,b` (binary
join) in fp64. Also `--config` (the same result as the equivalent flags)
and `--profile_dir` (a Chrome trace with the annotated phases)."""

import filecmp
import json
import os
import re

import numpy as np
import pytest

from nngp_tpu.cli import clean_schema as j_clean
from nngp_tpu.cli import sample_queries as j_sample
from nngp_tpu.cli import train as j_train
from nngp_tpu_torch.cli import clean_schema, sample_queries, train
from tests.test_loader_onramp import _make_schema_csvs, _make_single_table_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")


def _forest_csv(d, n=240, seed=3):
    """A headerless 12-column Covertype-shaped file (the loader keeps
    columns 0..9)."""
    rng = np.random.default_rng(seed)
    rows = np.column_stack([rng.integers(0, 300, n) for _ in range(12)])
    np.savetxt(d / "forest.csv", rows, fmt="%d", delimiter=",")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Tiny raw tables: tpch, imdb, forest, yelp-review and yelp-user."""
    root = tmp_path_factory.mktemp("raw")
    for schema in ("tpch", "imdb"):
        (root / schema).mkdir()
        _make_schema_csvs(schema, root / schema)
    single = root / "single"
    single.mkdir()
    _forest_csv(single)
    for relation in ("yelp-review", "yelp-user", "sales"):
        _make_single_table_csv(relation, single, n=60)
    return root


def _same_dirs(a, b, count):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == count
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("flags,count", [
    (["--schema_name", "tpch", "--serial", "--data_centric",
      "--mini_batch", "20"], 4),
    (["--schema_name", "imdb", "--serial", "--mini_batch", "10",
      "--nrows", "70"], 6),
    (["--relations", "forest", "--mini_batch", "10", "--cat_size", "5"], 10),
    (["--relations", "sales", "--serial", "--data_centric",
      "--mini_batch", "12"], 4),
    (["--binary", "--relations", "yelp-review,yelp-user", "--data_centric",
      "--mini_batch", "15"], 4),
], ids=["tpch-data_centric", "imdb-nrows", "forest-processes", "sales",
        "binary"])
def test_sample_queries_writes_the_jax_files(raw, tmp_path, flags, count,
                                              capsys):
    sub = "single" if "--relations" in flags else flags[1]
    data = ["--data_path", str(raw / sub)]
    sample_queries.main([*flags, *data, "--save_path", str(tmp_path / "p")])
    j_sample.main([*flags, *data, "--save_path", str(tmp_path / "j")])
    assert "wrote query files" in capsys.readouterr().out
    _same_dirs(tmp_path / "p", tmp_path / "j", count)


@pytest.mark.parametrize("flags", [[], ["--int_cast"], ["--nrows", "30"]],
                         ids=["plain", "int_cast", "nrows"])
@pytest.mark.parametrize("schema", ["tpch", "imdb"])
def test_clean_schema_writes_the_jax_bytes(raw, tmp_path, schema, flags):
    base = ["--schema_name", schema, "--data_path", str(raw / schema), *flags]
    clean_schema.main([*base, "--out_dir", str(tmp_path / "p")])
    j_clean.main([*base, "--out_dir", str(tmp_path / "j")])
    _same_dirs(tmp_path / "p", tmp_path / "j", 4 if schema == "tpch" else 6)


def test_sample_queries_needs_one_source():
    with pytest.raises(SystemExit, match="exactly one"):
        sample_queries.main(["--data_path", "x"])
    with pytest.raises(SystemExit, match="exactly two"):
        sample_queries.main(["--binary", "--relations", "forest",
                             "--data_path", "x"])


_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


def _printed(text):
    """The lines both training CLIs print, without timings and memory:
    (the line with its decimals blanked, its decimals)."""
    return [(_NUMBER.sub("#", line),
             [float(v) for v in _NUMBER.findall(line)])
            for line in text.splitlines()
            if line and not line.startswith(("[timing]", "memory:",
                                             "profiler"))]


def same_printed(got, want, rel=1e-8):
    """The same lines; decimals within `rel` (the profile prints 15
    digits, beyond what two Cholesky implementations share); the q-error
    headline to every printed digit."""
    got, want = _printed(got), _printed(want)
    assert [g for g, _ in got] == [w for w, _ in want]
    for (line, g), (_, w) in zip(got, want):
        if line.startswith("symmetric q-error"):
            assert g == w, line
        else:
            np.testing.assert_allclose(g, w, rtol=rel, err_msg=line)


@pytest.fixture(scope="module")
def labeled(raw, tmp_path_factory):
    """Labeled queries sampled from the raw tables by the port's CLI."""
    root = tmp_path_factory.mktemp("labeled")
    runs = {"tpch": ["--schema_name", "tpch", "--data_path",
                     str(raw / "tpch"), "--mini_batch", "40"],
            "forest": ["--relations", "forest", "--data_path",
                       str(raw / "single"), "--mini_batch", "30"],
            "binary": ["--binary", "--relations", "yelp-review,yelp-user",
                       "--data_path", str(raw / "single"),
                       "--mini_batch", "40"]}
    for name, argv in runs.items():
        sample_queries.main([*argv, "--serial", "--data_centric",
                             "--save_path", str(root / name)])
    return root


@pytest.mark.parametrize("case", ["forest", "tpch", "binary"])
def test_train_from_csvs_prints_what_the_jax_cli_prints(raw, labeled, case,
                                                        capsys):
    """--data_path (stats from the raw CSV: single table through
    `single_table_stats`, a schema through DBSchema) and --relations a,b
    (a binary join through `load_binary_join_workload`), fp64."""
    flags = {"forest": ["--relations", "forest", "--names", "forest",
                        "--data_path", str(raw / "single")],
             "tpch": ["--schema_name", "tpch", "--data_path",
                      str(raw / "tpch")],
             "binary": ["--relations", "yelp-review,yelp-user",
                        "--names", "review,user",
                        "--data_path", str(raw / "single")]}[case]
    argv = ["--query_path", str(labeled / case), "--x64", *flags]
    capsys.readouterr()
    got = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    want = j_train.main(argv)
    jax_out = capsys.readouterr().out
    same_printed(out, jax_out)
    assert got == pytest.approx(want, rel=1e-9)
    assert "num_table" in out or case == "forest"


def test_config_gives_the_result_of_its_flags(tmp_path, capsys):
    """--config seeds the defaults from a RunConfig JSON (either
    package's): the same lines as the equivalent flags and as the JAX CLI
    with the same file."""
    from nngp_tpu_torch.utils.config import RunConfig, SplitConfig

    cfg = RunConfig(split=SplitConfig(max_num_train=300, seed=4), x64=True)
    cfg.kernel.diag_reg = 3e-3
    path = tmp_path / "run.json"
    path.write_text(cfg.to_json())
    capsys.readouterr()
    train.main(["--device", "cpu", "--config", str(path)])
    by_config = capsys.readouterr().out
    train.main(["--device", "cpu", "--max_num_train", "300", "--seed", "4",
                "--diag_reg", "3e-3", "--x64"])
    by_flags = capsys.readouterr().out
    j_train.main(["--config", str(path)])
    jax_out = capsys.readouterr().out
    assert _printed(by_config) == _printed(by_flags)
    same_printed(by_config, jax_out)
    # an explicit flag still overrides the file
    train.main(["--device", "cpu", "--config", str(path), "--seed", "10"])
    assert "train (300, 20)" in capsys.readouterr().out


def test_profile_dir_writes_a_chrome_trace(tmp_path, capsys):
    from nngp_tpu_torch.utils.profiling import device_kernels

    prof = tmp_path / "prof"
    train.main(["--device", "cpu", "--query_path", FOREST,
                "--max_num_train", "200", "--profile_dir", str(prof)])
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fit_warm", "infer_warm"} <= names
    # no device on the CPU: the trace holds no kernel events
    assert device_kernels(str(prof / traces[0])) == {}
