"""`nngp_tpu_torch.cli.profile_slice` on the CPU: the interval union that
gives the device-busy time, and a small run of the whole script (on the
CPU only the host-clock wall is measured; the device fields stay null)."""

import json
import os

import pytest

import tests.test_torch_common  # noqa: F401  (two torch threads)
from nngp_tpu_torch.cli import profile_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (5.0, 6.5)], 3.5),              # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),              # nested
    ([(3.0, 6.0), (0.0, 4.0), (6.0, 7.0)], 7.0),  # overlapping, touching
])
def test_union_length(intervals, want):
    assert profile_slice.union_length(intervals) == want


@pytest.mark.parametrize("kernel_type", ["nngp", "ntk"])
def test_profile_runs_on_the_cpu(kernel_type, capsys):
    records = profile_slice.main([
        "--device", "cpu", "--query_path", FOREST, "--max_num_train", "200",
        "--kernel_type", kernel_type, "--reps", "1"])
    out = capsys.readouterr().out
    assert [r["phase"] for r in records] == ["fit", "predict"]
    assert out.count('{"phase": ') == 2
    for rec in records:
        assert rec["kernel_type"] == kernel_type
        assert rec["dtype"] == "float32"
        assert (rec["n_train"], rec["n_test"]) == (200, 3600)
        assert rec["wall_ms"] > 0
        assert rec["busy_ms"] is None and rec["idle"] is None


def test_profile_learning_phases_run_on_the_cpu(capsys, monkeypatch):
    """The hyperopt phases (3 restarts and 1) and the greedy phase (cut to
    8 of 64 rows): one JSON line each, with a step time for a learn."""
    monkeypatch.setattr(profile_slice, "GREEDY_POOL", 64)
    monkeypatch.setattr(profile_slice, "GREEDY_K", 8)
    phases = ["hyperopt", "hyperopt_warm", "greedy"]
    records = profile_slice.main([
        "--device", "cpu", "--query_path", FOREST, "--max_num_train", "200",
        "--x64", "--phases", ",".join(phases), "--hyper_points", "64",
        "--hyper_steps", "2", "--reps", "1"])
    out = capsys.readouterr().out
    assert [r["phase"] for r in records] == phases
    assert out.count('{"phase": ') == 3
    for rec in records:
        assert rec["dtype"] == "float64"
        assert rec["wall_ms"] > 0
        assert rec["busy_ms"] is None and rec["launches"] is None
    assert [("step_ms" in r) for r in records] == [True, True, False]


@pytest.mark.parametrize("moments", ["fp32", "df64"])
def test_profile_nystrom_phases_run_on_the_cpu(moments, capsys):
    """The Nystrom tier's fit and chunked predict: one JSON line each; the
    exact fit is skipped when no exact phase is asked for."""
    phases = ["nystrom_fit", "nystrom_predict"]
    records = profile_slice.main([
        "--device", "cpu", "--query_path", FOREST, "--max_num_train", "300",
        "--nystrom_m", "32", "--nystrom_moments", moments, "--phases",
        ",".join(phases), "--reps", "1"])
    capsys.readouterr()
    assert [r["phase"] for r in records] == phases
    for rec in records:
        assert rec["dtype"] == "float32" and rec["wall_ms"] > 0
        assert (rec["n_train"], rec["n_test"]) == (300, 3600)
        assert rec["busy_ms"] is None


def test_profile_baseline_phases_run_on_the_cpu(capsys):
    """One epoch of the DNN baseline (ceil(300 / 128) = 3 optimizer steps)
    and one full-batch step of DKL-SKI: one JSON line each, fp32 whatever
    --x64 says, with the time per optimizer step; neither needs the exact
    fit."""
    phases = ["baseline_dnn", "baseline_ski"]
    records = profile_slice.main([
        "--device", "cpu", "--query_path", FOREST, "--max_num_train", "300",
        "--x64", "--phases", ",".join(phases), "--reps", "1"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [json.loads(l)["phase"] for l in lines] == phases
    assert [r["steps"] for r in records] == [3, 1]
    for rec in records:
        assert rec["dtype"] == "float32" and rec["kernel_type"] is None
        assert rec["step_ms"] == pytest.approx(rec["wall_ms"] / rec["steps"])
        assert rec["wall_ms"] > 0 and rec["busy_ms"] is None
        assert (rec["n_train"], rec["n_test"]) == (300, 3600)


def test_profile_rejects_unported_flags_and_bad_reps(capsys):
    for flags in (["--learn_hyper"], ["--reps", "0"],
                  ["--phases", "fit,bogus"],
                  ["--phases", "hyperopt", "--hyper_steps", "0"],
                  ["--phases", "nystrom_fit"]):
        with pytest.raises(SystemExit) as exc:
            profile_slice.main(["--device", "cpu", *flags])
        assert exc.value.code == 2
    capsys.readouterr()
