"""The port's baseline CLIs (`cli.train_baselines`, `cli.train_multijoin`,
`cli.train --kernel_type gp`) on `--device cpu` at a small size: every model
type runs and prints the q-error line; the deterministic ones print what the
JAX CLIs print (RBF-GP in fp64 to rel 1e-6 of every printed number, the
sklearn types exactly); with no card and no `--device cpu` they stop with an error;
`--data_path` raises naming its ROADMAP item; and, in a fresh interpreter
with jax, flax, optax, pandas and the JAX package blocked, the three CLIs
run.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from nngp_tpu.cli import train as jax_train
from nngp_tpu.cli import train_baselines as jax_baselines
from nngp_tpu.cli import train_multijoin as jax_multijoin
from nngp_tpu_torch.cli import train, train_baselines, train_multijoin
from tests.test_torch_serve_frontends import _BLOCK_HOOK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")
SYNTH = os.path.join(REPO, "workloads", "synth_join_data")
SYNTH_STATS = os.path.join(REPO, "workloads", "synth_stats")
QERR = re.compile(r"symmetric q-error: median=([0-9.]+) p95=([0-9.]+)")
SMALL = ["--query_path", FOREST, "--max_num_train", "200", "--epochs", "1",
         "--num_hid", "16"]


def _qerror(text):
    m = QERR.search(text)
    assert m, text[-500:]
    med, p95 = float(m.group(1)), float(m.group(2))
    assert 1.0 <= med <= p95
    return med, p95


@pytest.mark.parametrize("model_type", train_baselines.MODEL_TYPES)
def test_train_baselines_every_model_type_runs(model_type, capsys):
    train_baselines.main(["--device", "cpu", "--model_type", model_type,
                          *SMALL])
    out = capsys.readouterr().out
    assert f"{model_type} mean square error: " in out
    assert "Query attributes:num_table=1" in out
    _qerror(out)
    if model_type not in ("GP", "KRR", "MLP", "XGB", "RBF-GP"):
        assert "0-th Epochs: " in out
    if model_type != "MSCN":
        assert "number of query: 18000" in out
        assert "train (200, 20)  test (3600, 20)" in out


def test_model_types_are_the_jax_clis():
    assert train_baselines.MODEL_TYPES == jax_baselines.MODEL_TYPES
    ours = {a.dest: a.default for a in train_baselines.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_baselines.build_parser()._actions}
    assert ours.pop("device") == "cuda" and ours.pop("seed") == 0
    assert ours == theirs
    ours = {a.dest: a.default for a in train_multijoin.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_multijoin.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.mark.parametrize("model_type", ["KRR", "XGB"])
def test_sklearn_model_types_print_what_the_jax_cli_prints(model_type,
                                                           capsys):
    argv = ["--model_type", model_type, *SMALL]
    train_baselines.main(argv)          # host-side: no --device needed
    out = capsys.readouterr().out
    jax_baselines.main(argv)
    assert out == capsys.readouterr().out


def test_rbf_gp_baseline_tracks_the_jax_cli_in_fp32(capsys):
    argv = ["--model_type", "RBF-GP", *SMALL]
    train_baselines.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    jax_baselines.main(argv)
    jout = capsys.readouterr().out
    assert out.count("neg marginal likelihood") == 10
    (med, p95), (jmed, jp95) = _qerror(out), _qerror(jout)
    assert med == pytest.approx(jmed, rel=1e-3)
    assert p95 == pytest.approx(jp95, rel=1e-3)


def test_kernel_type_gp_prints_what_the_jax_cli_prints(capsys):
    argv = ["--kernel_type", "gp", "--query_path", FOREST, "--x64",
            "--max_num_train", "200", "--calibration"]
    profile = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    jprofile = jax_train.main(argv)
    jout = capsys.readouterr().out

    def headline(text):
        keep = ("number of query", "train (", "Step: ", "Mean Square",
                "symmetric q-error", "Expected/Observed")
        return [l for l in text.splitlines() if l.startswith(keep)]

    def timing_labels(text):
        return [l.rsplit(":", 1)[0] for l in text.splitlines()
                if l.startswith("[timing]")]

    # raw features reach 1000, so squared distances carry ~1e-9 of
    # rounding that the 1 / noise of the solve amplifies: the printed
    # numbers agree to ~1e-8, not to every digit
    number = re.compile(r"-?\d+\.\d+(?:e[+-]?\d+)?")
    lines, jlines = headline(out), headline(jout)
    assert len(lines) == len(jlines) > 14
    for ours, theirs in zip(lines, jlines):
        assert number.sub("#", ours) == number.sub("#", theirs)
        assert [float(v) for v in number.findall(ours)] == pytest.approx(
            [float(v) for v in number.findall(theirs)], rel=1e-6)
    assert timing_labels(out) == timing_labels(jout) == [
        "[timing] GP hyperparameter training (10 MLL steps)",
        "[timing] GP inference (cold, incl. compile)",
        "[timing] GP inference (warm)"]
    assert profile["median"] == pytest.approx(jprofile["median"], rel=1e-8)


@pytest.mark.parametrize("model_type", ["MSCN", "TLSTM"])
def test_train_multijoin_runs(model_type, capsys):
    train_multijoin.main(["--device", "cpu", "--model_type", model_type,
                          "--query_path", SYNTH, "--stats_dir", SYNTH_STATS,
                          "--epochs", "2", "--num_hid", "16"])
    out = capsys.readouterr().out
    assert "number of query: 2400" in out
    assert f"{model_type} mean square error: " in out
    assert "1-th Epochs: Train MSE Loss=" in out
    assert sum(int(c) for c in re.findall(r"# Queries = (\d+)", out)) == 480
    _qerror(out)


def test_multijoin_schema_name_orders_the_tables(tmp_path, capsys):
    """--schema_name lays the stats out in the schema's table order
    (`SCHEMA_TABLES`) where the port knows the schema, as the JAX CLI does
    through its loaders' table; an unknown name keeps the file order."""
    from nngp_tpu_torch.cli.train_multijoin import _load_stats, build_parser

    base = ["--query_path", SYNTH, "--stats_dir", SYNTH_STATS]
    plain = _load_stats(build_parser().parse_args(base))
    named = _load_stats(build_parser().parse_args(
        [*base, "--schema_name", "synth"]))
    assert [s.table_name for s in named] == [s.table_name for s in plain]
    with pytest.raises(SystemExit, match="pass --stats_dir"):
        train_multijoin.main(["--device", "cpu", "--query_path", SYNTH])


@pytest.mark.parametrize("argv", [
    ["--model_type", "DNN"],
    ["--model_type", "DKL-SKI"],
    ["--model_type", "MSCN"],
], ids=lambda a: a[1])
def test_without_a_card_the_default_device_is_an_error(argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda resolves instead of raising")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_baselines.main([*argv, *SMALL])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_multijoin.main(["--query_path", SYNTH, "--stats_dir",
                              SYNTH_STATS])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--kernel_type", "gp", "--query_path", FOREST,
                    "--max_num_train", "50"])


def test_baseline_clis_run_with_jax_flax_optax_and_pandas_blocked():
    # torch.optim probes for optional packages (pandas among them) with
    # find_spec when torch._dynamo is first imported: let it, before the
    # hook turns every such lookup into an error
    code = "import torch._dynamo\n" + _BLOCK_HOOK + (
        "from nngp_tpu_torch.cli import train, train_baselines, "
        "train_multijoin\n"
        "small = ['--device', 'cpu', '--max_num_train', '100', '--epochs',\n"
        "         '1', '--num_hid', '8']\n"
        "for mt in ('DNN', 'DeepEnsemble', 'DKL-SKI', 'MSCN', 'KRR'):\n"
        "    train_baselines.main(['--model_type', mt, *small])\n"
        "train_multijoin.main(['--device', 'cpu', '--model_type', 'TLSTM',\n"
        "    '--query_path', 'workloads/synth_join_data', '--stats_dir',\n"
        "    'workloads/synth_stats', '--epochs', '1', '--num_hid', '8'])\n"
        "train.main(['--device', 'cpu', '--kernel_type', 'gp',\n"
        "            '--max_num_train', '100'])\n"
        "from nngp_tpu_torch.active import BaselineActiveLearner\n"
        "loaded = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas',\n"
        "                      'nngp_tpu') if m in sys.modules]\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("symmetric q-error: median=") == 7
    assert "LOADED []" in proc.stdout
