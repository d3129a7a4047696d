"""The port's active-learning CLI (`nngp_tpu_torch.cli.active_train`)
against the JAX CLI on the committed synth join workload (2,400 queries:
480 train, 1,440 pool, 480 validation), fp64 on the CPU: the same
validation MSE per round (rtol 1e-9) and the same printed headline lines;
a JAX-written --hyper_file driving the port; and the flags' usage
errors.
"""

import os

import numpy as np
import pytest

import nngp_tpu.gp.posterior as JP
from nngp_tpu.cli import active_train as jax_cli
from nngp_tpu_torch.cli import active_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "workloads", "synth_join_data")


@pytest.fixture(scope="module", autouse=True)
def jax_exact_diag():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_FUSED_FIT_MIN_N", 16)
        yield


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("extra", [
    ["--selection", "topk", "--refit", "full"],
    ["--selection", "greedy", "--learn_hyper", "--ard",
     "--hyper_points", "64", "--hyper_steps", "5"],
], ids=["topk-full", "greedy-ard"])
def test_cli_matches_jax_cli(extra, capsys):
    argv = ["--x64", "--schema_name", "synth", "--query_path", SYNTH,
            "--budget", "60", "--active_iters", "2", *extra]
    want = jax_cli.main(argv)
    jax_out = capsys.readouterr().out
    got = active_train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)
    for prefix in ("number of query", "train (", "learned", "Active",
                   "# "):
        assert [l for l in out.splitlines() if l.startswith(prefix)] == \
            [l for l in jax_out.splitlines() if l.startswith(prefix)]


def test_cli_hyper_file_from_jax_and_relearn(tmp_path, capsys):
    """An artifact the JAX CLI learned and saved drives the port's
    relearn run, which equals the JAX CLI's relearn run from it."""
    path = str(tmp_path / "hyper.json")
    base = ["--x64", "--schema_name", "synth", "--query_path", SYNTH,
            "--budget", "60", "--active_iters", "2", "--biased_sample",
            "--selection", "topk", "--hyper_file", path,
            "--hyper_points", "64", "--hyper_steps", "5"]
    jax_cli.main(base + ["--learn_hyper"])
    assert os.path.exists(path)
    capsys.readouterr()
    want = jax_cli.main(base + ["--relearn_hyper"])
    got = active_train.main(["--device", "cpu", *base, "--relearn_hyper"])
    out = capsys.readouterr().out
    assert out.count(f"loaded hyperparameters from {path}") == 2
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)


@pytest.mark.parametrize("flags,jax_flags,rtol", [
    (["--x64", "--nystrom_m", "64"], ["--x64", "--nystrom_m", "64"], 1e-9),
    (["--x64", "--nystrom_m", "64", "--nystrom_grow", "16"],
     ["--x64", "--nystrom_m", "64", "--nystrom_grow", "16"], 1e-9),
    (["--nystrom_m", "64", "--nystrom_moments", "df64"],
     ["--x64", "--nystrom_m", "64"], 1e-3),
], ids=["m", "grow", "df64"])
def test_cli_nystrom_flags_match_jax_cli(flags, jax_flags, rtol, capsys):
    """The Nystrom flags (once refused, now ported), top-k, against the
    JAX CLI: the same validation MSE per round (rtol 1e-9 in fp64);
    --nystrom_moments df64 on fp32 rows against JAX's fp64 run at rtol
    1e-3 (the fp32 predict and the 1e-12 rank cut)."""
    base = ["--schema_name", "synth", "--query_path", SYNTH, "--budget",
            "60", "--active_iters", "2", "--selection", "topk"]
    want = jax_cli.main(base + jax_flags)
    got = active_train.main(["--device", "cpu", *base, *flags])
    capsys.readouterr()
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=rtol)


@pytest.mark.parametrize("flags,item", [
    (["--mesh_devices", "4"], "world size is 1"),
    (["--pad_acquisitions", "--nystrom_m", "16"],
     "--pad_acquisitions pads the single-device exact nngp posterior"),
])
def test_cli_unported_flags_name_their_item(flags, item, capsys):
    """--mesh_devices must be the world size (1 without a launcher), and
    --pad_acquisitions (ported) pads the single-device exact tier only.
    Both are usage errors."""
    with pytest.raises(SystemExit) as exc:
        active_train.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


def test_cli_full_n_exact_hyperopt_is_refused():
    with pytest.raises(SystemExit, match="requires the DTC objective"):
        active_train.main(["--device", "cpu", "--schema_name", "synth",
                           "--query_path", SYNTH, "--learn_hyper",
                           "--hyper_points", "0"])
