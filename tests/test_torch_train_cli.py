"""The port's training CLI (`nngp_tpu_torch.cli.train`) end to end against
the JAX CLI on the committed forest and synth join workloads, fp64 on the
CPU, with and without hyperparameters learned by evidence (--learn_hyper,
--ard, --select_kernel, --hyper_file artifacts of either package); its
errors for paths not ported yet; and, in a fresh interpreter, that the
slice loads neither jax nor pandas.

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


@pytest.mark.parametrize("flags,jax_flags,rel", [
    (["--x64", "--nystrom_m", "64"], ["--x64", "--nystrom_m", "64"], 1e-6),
    (["--nystrom_m", "64", "--nystrom_moments", "df64"],
     ["--x64", "--nystrom_m", "64"], 1e-3),
], ids=["fp64", "fp32-df64"])
def test_nystrom_flags_match_jax_cli(flags, jax_flags, rel, capsys):
    """--nystrom_m fits the streaming tier: the profile of the JAX CLI's
    fp64 run at rel 1e-6, and with fp32 rows and --nystrom_moments df64
    at rel 1e-3 (the port's df64 is native fp64, but the rows, the
    predict and the 1e-12 rank cut (fp64: 1e-14) are fp32-shaped)."""
    base = ["--query_path", FOREST, "--max_num_train", "400"]
    want = jax_train.main(base + jax_flags)
    capsys.readouterr()
    got = train.main(["--device", "cpu", *base, *flags])
    out = capsys.readouterr().out
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=rel), key
    assert len(_lines(out, "[timing] ")) == 4
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", *base, *flags, "--select_reg",
                    "1e-3,1e-2"])
    assert "drop --nystrom_m" in capsys.readouterr().err


HYPER = ["--hyper_points", "96", "--hyper_steps", "8"]


@pytest.mark.parametrize("extra", [
    ["--learn_hyper", *HYPER],
    ["--learn_hyper", "--ard", "--kernel_type", "ntk", *HYPER],
    ["--learn_hyper", "--hyper_objective", "dtc", "--b_std", "0.3",
     "--diag_reg", "1e-2", *HYPER],
], ids=["scalar", "ard-ntk", "dtc"])
def test_learn_hyper_matches_jax_cli(extra, capsys, monkeypatch):
    """--learn_hyper: the same learned-hyperparameter lines, the ARD
    scale applied to train and test rows, the fit with the learned spec
    and ridge (prescale off, b != 0), the same profile (rel 1e-6)."""
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)
    argv = ["--x64", "--query_path", FOREST, "--max_num_train", "200",
            *extra]
    want = jax_train.main(argv)
    jax_out = capsys.readouterr().out
    got = train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    for prefix in ("learned hyperparameters", "learned ARD"):
        assert _lines(out, prefix) == _lines(jax_out, prefix)
    assert len(_lines(out, "learned hyperparameters")) == 1
    assert len(_lines(out, "[timing] ")) == 5


def test_hyper_file_artifacts_cross_between_the_clis(tmp_path, capsys,
                                                     monkeypatch):
    """An artifact learned and saved by the JAX CLI serves the port's
    CLI, and one saved by the port's serves the JAX CLI; each loaded run
    gives the profile of the run that learned it."""
    monkeypatch.setattr(JP, "_FUSED_FIT_MIN_N", 64)
    base = ["--x64", "--query_path", FOREST, "--max_num_train", "200",
            "--ard", *HYPER]
    jax_file, port_file = str(tmp_path / "jax.json"), str(tmp_path / "p.json")
    jax_learned = jax_train.main(base + ["--learn_hyper", "--hyper_file",
                                         jax_file])
    port_learned = train.main(["--device", "cpu", *base, "--learn_hyper",
                               "--hyper_file", port_file])
    out = capsys.readouterr().out
    assert out.count("saved hyperparameter artifact") == 2
    on_port = train.main(["--device", "cpu", *base, "--hyper_file",
                          jax_file])
    on_jax = jax_train.main(base + ["--hyper_file", port_file])
    out = capsys.readouterr().out
    assert out.count("loaded hyperparameters from") == 2
    for key in jax_learned:
        assert on_port[key] == pytest.approx(jax_learned[key], rel=1e-6)
        assert on_jax[key] == pytest.approx(port_learned[key], rel=1e-6)


def test_select_kernel_ranks_six_structures(capsys):
    """--select_kernel competes depth 1..3 x (relu, erf) on evidence and
    fits the winner; the grid lines are `select_kernel`'s (held against
    JAX in tests/test_torch_hyperopt.py)."""
    profile = train.main(["--device", "cpu", "--x64", "--query_path",
                          FOREST, "--max_num_train", "120", "--select_kernel",
                          "--hyper_points", "48", "--hyper_steps", "3"])
    out = capsys.readouterr().out
    grid = _lines(out, "depth=")
    assert len(grid) == 6 and "log evidence" in grid[0]
    best = max(grid, key=lambda l: float(l.split("log evidence ")[1]
                                         .split()[0]))
    depth, act = best.split(":")[0].split()
    assert _lines(out, "selected kernel: ") == [
        f"selected kernel: {depth} activation={act.split('=')[1]}"]
    assert all(np.isfinite(v) for v in profile.values())


def test_full_n_exact_hyperopt_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--query_path", FOREST,
                    "--learn_hyper", "--hyper_points", "0"])
    assert exc.value.code == 2
    assert "requires the DTC objective" in capsys.readouterr().err


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
