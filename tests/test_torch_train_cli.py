"""The port's training CLI (`nngp_tpu_torch.cli.train`) end to end against
the JAX CLI on the committed forest and synth join workloads, fp64 on the
CPU; its errors for paths not ported yet; and, in a fresh interpreter,
that the slice loads neither jax nor pandas.

The JAX runs take the exact-diagonal fit path the forest workload takes at
full size (see tests/test_torch_posterior.py). The q-error profile must
agree at rel 1e-6.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nngp_tpu.gp.posterior as JP
from nngp_tpu.cli import train as jax_train
from nngp_tpu_torch.cli import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")
SYNTH = os.path.join(REPO, "workloads", "synth_join_data")


def _lines(text, prefix):
    return [l for l in text.splitlines() if l.startswith(prefix)]


@pytest.mark.parametrize("extra", [
    ["--kernel_type", "nngp", "--max_num_train", "1000", "--calibration"],
    ["--kernel_type", "ntk", "--max_num_train", "1000"],
    ["--kernel_type", "nngp", "--uneven_split", "num_predicates",
     "--train_frac", "0.05", "--depth", "2", "--activation", "erf",
     "--b_std", "0.1"],
], ids=["nngp", "ntk", "uneven-erf2"])
def test_cli_matches_jax_cli(extra, capsys, monkeypatch):
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)
    argv = ["--x64", "--query_path", FOREST, *extra]
    want = jax_train.main(argv)
    jax_out = capsys.readouterr().out
    got = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    for prefix in ("number of query", "train ", "Expected/Observed"):
        assert _lines(out, prefix) == _lines(jax_out, prefix)
    mse = [float(_lines(o, "Mean Square Error: ")[0].split(": ")[1])
           for o in (out, jax_out)]
    assert mse[0] == pytest.approx(mse[1], rel=1e-6)
    assert len(_lines(out, "symmetric q-error: median=")) == 1
    assert len(_lines(out, "[timing] ")) == 4


@pytest.mark.parametrize("extra", [
    ["--schema_name", "synth", "--query_path", SYNTH, "--max_num_train",
     "600"],
    ["--schema_name", "synth", "--query_path", SYNTH, "--max_num_train",
     "600", "--chunk_norm", "--kernel_type", "ntk"],
    ["--query_path", FOREST, "--max_num_train", "400", "--select_reg",
     "1e-4,1e-3,1e-2"],
], ids=["synth", "synth-chunk_norm-ntk", "forest-select_reg"])
def test_multi_join_and_select_reg_match_jax_cli(extra, capsys,
                                                 monkeypatch):
    """--schema_name (the multi-join loader) and --select_reg (the ridge
    by evidence) print what the JAX CLI prints and return its profile."""
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)
    argv = ["--x64", *extra]
    want = jax_train.main(argv)
    jax_out = capsys.readouterr().out
    got = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    for prefix in ("number of query", "train ", "diag_reg="):
        assert len(_lines(out, prefix)) == len(_lines(jax_out, prefix))
    for line, jax_line in zip(_lines(out, "diag_reg="),
                              _lines(jax_out, "diag_reg=")):
        assert line.split(":")[0] == jax_line.split(":")[0]
        assert line.endswith("selected") == jax_line.endswith("selected")
        assert float(line.split()[3]) == pytest.approx(
            float(jax_line.split()[3]), rel=1e-6)
    assert _lines(out, "number of query") == _lines(jax_out,
                                                    "number of query")


def test_cli_device_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs instead of raising")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--device", "cuda", "--query_path", FOREST,
                    "--max_num_train", "50"])


@pytest.mark.parametrize("flags,item", [
    (["--kernel_type", "gp"], "Queue A #11"),
    (["--nystrom_m", "64"], "Queue A #10"),
    (["--learn_hyper"], "Queue A #9"),
    (["--select_kernel"], "Queue A #9"),
    (["--hyper_file", "hyper.json"], "Queue A #9"),
    (["--relations", "title,cast_info"], "Queue A #7"),
    (["--profile_dir", "trace"], "Queue A #13"),
    (["--config", "run.json"], "Queue A #13"),
    (["--nystrom_moments", "df64"], "Queue A #10"),
    (["--hyper_steps", "50"], "Queue A #9"),
    (["--hyper_points", "1024"], "Queue A #9"),
    (["--ard"], "Queue A #9"),
    (["--hyper_objective", "exact"], "Queue A #9"),
])
def test_unported_flags_name_their_roadmap_item(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP {item}" in err


@pytest.mark.parametrize("schema", [None, "synth"])
def test_data_path_is_not_ported_yet(schema):
    query_path = SYNTH if schema else FOREST
    extra = ["--schema_name", schema] if schema else []
    with pytest.raises(NotImplementedError, match="CSV loading not ported"):
        train.main(["--device", "cpu", "--query_path", query_path,
                    "--data_path", "raw_csvs", "--max_num_train", "50",
                    *extra])


def test_slice_imports_neither_jax_nor_pandas():
    """A fresh interpreter: this process already imported jax (conftest)."""
    code = (
        "import sys\n"
        "import nngp_tpu_torch\n"
        "from nngp_tpu_torch.cli import train\n"
        "profile = train.main(['--device', 'cpu', '--query_path', "
        f"{FOREST!r}, '--max_num_train', '200'])\n"
        "assert profile['count'] == 3600, profile\n"
        "loaded = [m for m in ('jax', 'jaxlib', 'pandas') "
        "if m in sys.modules]\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.search(r"symmetric q-error: median=\d", proc.stdout)
    assert "LOADED []" in proc.stdout


def test_profile_is_finite_and_counts_the_test_split(capsys):
    profile = train.main(["--device", "cpu", "--query_path", FOREST,
                          "--max_num_train", "300", "--kernel_type", "ntk"])
    capsys.readouterr()
    assert profile["count"] == 3600
    assert all(np.isfinite(v) for v in profile.values())
