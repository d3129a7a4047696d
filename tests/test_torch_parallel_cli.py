"""The distributed tier's command lines on the CPU: `--mesh_devices` and
`--tier distributed` of the serving demo and the active-learning CLI (one
rank in this process, and two under torchrun), the multi-rank dry run
`python -m nngp_tpu_torch.parallel.dryrun`. (The scan that no mesh
surface still raises as unported is in test_torch_serve_frontends.py.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nngp_tpu_torch.cli import active_train, serve_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = ["--schema_name", "synth", "--stats_dir", "workloads/synth_stats",
         "--train_query_path", "workloads/synth_join_data",
         "--test_query_file", "workloads/synth_join_data/join_query_2.txt",
         "--limit", "50"]
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _first5(out):
    rows = out.split("first 5")[1].split("\n")[1:6]
    return np.asarray([r.split()[:2] for r in rows], float)


@pytest.fixture(scope="module", autouse=True)
def in_repo():
    cwd = os.getcwd()
    os.chdir(REPO)
    yield
    os.chdir(cwd)


def test_serve_demo_distributed_tier_saves_and_restores(tmp_path, capsys):
    """--mesh_devices 1 --tier distributed fits the row-sharded posterior
    and writes the JAX package's distributed checkpoint, which the next
    run restores over the mesh and predicts from unchanged. (The demo is
    fp32 on the raw synth encoding, where fp32 rounding alone moves the
    means by tenths, ROADMAP Queue C: the tiers are compared in fp64 in
    test_torch_parallel_serve.py.)"""
    ck = str(tmp_path / "ck")
    flags = ["--device", "cpu", *SYNTH, "--mesh_devices", "1", "--tier",
             "distributed"]
    serve_demo.main(flags + ["--ckpt", ck])
    first = capsys.readouterr().out
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)["distributed"]
    assert meta["mesh_size"] == 1 and meta["axis_name"] == "data"
    serve_demo.main(flags + ["--ckpt", ck])
    again = capsys.readouterr().out
    assert "predicted 50 queries" in first and "restoring" in again
    assert np.all(np.isfinite(_first5(first)))
    np.testing.assert_array_equal(_first5(again), _first5(first))


def test_active_train_over_a_mesh_matches_one_device(capsys):
    base = ["--device", "cpu", "--schema_name", "synth", "--query_path",
            "workloads/synth_join_data", "--budget", "40", "--active_iters",
            "2", "--selection", "topk", "--x64"]
    got = active_train.main(base + ["--mesh_devices", "1"])
    want = active_train.main(base)
    capsys.readouterr()
    assert [h["num_train"] for h in got] == [h["num_train"] for h in want]
    np.testing.assert_allclose([h["val_mse"] for h in got],
                               [h["val_mse"] for h in want], rtol=1e-9)


def test_serve_demo_under_torchrun_prints_once(tmp_path):
    """Two ranks under torchrun: the process group comes from the
    launcher, every rank fits its rows, and only rank 0 prints."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "nngp_tpu_torch.cli.serve_demo",
         "--device", "cpu", *SYNTH, "--mesh_devices", "2", "--ckpt",
         str(tmp_path / "ck")], cwd=REPO, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("predicted 50 queries") == 1
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f)["distributed"]["mesh_size"] == 2


@pytest.mark.parametrize("args,ok", [(["2", "--n", "120", "--block_size",
                                       "8"], True),
                                      (["2", "--n", "120", "--block_size",
                                        "0"], False)])
def test_dryrun_exit_code(args, ok):
    """Two gloo ranks: one training step and the predicts against a plain
    fit, exit 0; a rank that fails (a zero block size) fails the run."""
    proc = subprocess.run(
        [sys.executable, "-m", "nngp_tpu_torch.parallel.dryrun", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    if ok:
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["world"] == 2 and line["n_padded"] == 128
        assert line["max_rel_err"] < 1e-8
    else:
        assert proc.returncode != 0
