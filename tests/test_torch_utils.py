"""The port's utilities and small CLIs against the JAX package's:
`utils/config.py` (RunConfig JSON both ways, the presets), `utils/timing.py`
(`sync`, `timed`), `utils/profiling.py` (`trace` into a Chrome trace,
`annotate`, `Metrics`), `utils/memory.py`, `eval/plots.py` (the same
permutations, the same calibration table, files drawn), `cli/sweep.py`
(rows equal to the JAX sweep's at a small n).
`tests/test_torch_serving_demo.py` runs `cli/production_serving_demo.py`."""

import json
import os

import numpy as np
import pytest
import torch

import nngp_tpu.eval.plots as JPL
import nngp_tpu.utils.config as JC
from nngp_tpu.cli import sweep as j_sweep
from nngp_tpu.featurize.parser import QueryInfo
from nngp_tpu_torch.cli import sweep
from nngp_tpu_torch.eval import plots as PL
from nngp_tpu_torch.utils import config as C
from nngp_tpu_torch.utils.memory import memory_usage_gb
from nngp_tpu_torch.utils.profiling import (Metrics, annotate,
                                            device_kernels, trace)
from nngp_tpu_torch.utils.timing import sync, timed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREST = os.path.join(REPO, "workloads", "forest_data")


@pytest.mark.parametrize("preset", ["forest", "imdb_simple", "tpcds"])
def test_run_config_json_is_the_jax_json_both_ways(preset):
    make = {"forest": lambda m: m.forest_preset(),
            "imdb_simple": lambda m: m.imdb_simple_preset("q", "d"),
            "tpcds": lambda m: m.tpcds_preset("q", "d")}[preset]
    cfg, jcfg = make(C), make(JC)
    assert cfg.to_json() == jcfg.to_json()
    cfg.kernel.depth = 3
    cfg.split.max_num_train = 77
    assert JC.RunConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
    assert C.RunConfig.from_json(cfg.to_json()) == cfg
    assert cfg.workload.join_query == jcfg.workload.join_query


def test_sync_and_timed_return_their_tree():
    t = torch.ones(3)
    tree = {"a": (t, [t * 2]), "b": 1.5}
    assert sync(tree) is tree
    out, secs = timed(lambda x: (x + 1, x), t, repeats=3)
    assert torch.equal(out[0], t + 1) and secs >= 0.0


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    with trace(str(tmp_path / "p")):
        with annotate("outer_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with trace(str(tmp_path / "p")):
        pass
    files = sorted(os.listdir(tmp_path / "p"))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    with open(tmp_path / "p" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert "outer_region" in {e.get("name") for e in events}
    assert device_kernels(str(tmp_path / "p" / files[0])) == {}


def test_device_kernels_reads_kernel_events_only(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 30.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fit", "dur": 99},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5.0}]}))
    assert device_kernels(str(path)) == {"k1": (2, 0.04)}


def test_metrics_record_timeit_dump(tmp_path):
    m = Metrics()
    m.record("n_train", 100)
    with m.timeit("phase") as holder:
        holder["out"] = torch.zeros(2)
    with annotate("region"):                 # no-op outside a trace
        pass
    out = tmp_path / "metrics.json"
    m.dump(str(out))
    payload = json.loads(out.read_text())
    assert payload["n_train"] == 100 and payload["phase_s"] >= 0


def test_memory_usage_reports_host_rss_and_no_card_on_the_cpu():
    out = memory_usage_gb("cpu")
    assert out.keys() == {"host_rss_gb"} and out["host_rss_gb"] > 0


def _infos(preds):
    return [QueryInfo(num_table=1, num_joins=0, num_predicates=p,
                      is_equal_join=False, is_multi_key=False)
            for p in preds]


def test_plots_permutations_and_calibration_are_the_jax_ones(tmp_path):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((6, 6))
    infos = _infos([3, 1, 2, 1, 2, 3])
    np.testing.assert_array_equal(
        PL.permute_kernel_matrix(k, infos, "num_predicates"),
        JPL.permute_kernel_matrix(k, infos, "num_predicates"))
    std = rng.uniform(0, 1, 6)
    np.testing.assert_array_equal(
        PL.permute_train_test_kernel_matrix(k, infos, "num_predicates", std),
        JPL.permute_train_test_kernel_matrix(k, infos, "num_predicates",
                                             std))
    mu = rng.standard_normal(500)
    y = mu + rng.standard_normal(500)
    sd = np.ones(500)
    assert PL.draw_calibration(y, mu, sd, str(tmp_path / "c.png")) == \
        JPL.draw_calibration(y, mu, sd, str(tmp_path / "j.png"))
    assert os.path.getsize(tmp_path / "c.png") > 0


def test_draw_functions_emit_files(tmp_path):
    rng = np.random.default_rng(1)
    k = torch.as_tensor(rng.standard_normal((6, 6)))
    PL.draw_kernel_heatmap(k @ k.T, str(tmp_path / "heat.png"))
    PL.draw_kernel_histogram(k, str(tmp_path / "hist.png"), bins=10)
    PL.draw_uncertainty(str(tmp_path / "unc.png"),
                        errors=rng.standard_normal(6),
                        uncertainty=rng.uniform(0, 1, 6),
                        y=rng.standard_normal(6))
    PL.draw_embeddings(rng.standard_normal((6, 2)), str(tmp_path / "emb.png"),
                       label=np.arange(6))
    for name in ("heat", "hist", "unc", "emb"):
        assert os.path.getsize(tmp_path / f"{name}.png") > 0


def test_sweep_rows_are_the_jax_rows(capsys):
    """fp32 in both packages at n = 300: the same configurations in the
    same order; q-errors, MSE and log evidence within fp32 rounding."""
    argv = ["--query_path", FOREST, "--max_num_train", "300",
            "--depths", "1,2", "--activations", "relu,erf"]
    rows = sweep.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    want = j_sweep.main(argv)
    jax_out = capsys.readouterr().out
    assert len(rows) == len(want) == 8
    for got, exp in zip(rows, want):
        assert [got[k] for k in ("depth", "activation", "kernel")] == \
            [exp[k] for k in ("depth", "activation", "kernel")]
        for key in ("mse", "median_q", "p95_q", "log_evidence"):
            assert got[key] == pytest.approx(exp[key], rel=2e-3), (exp, key)
    for text in (out, jax_out):
        assert text.splitlines()[-1].startswith("SWEEP_SUMMARY [")
    assert json.loads(out.splitlines()[-1].split(" ", 1)[1]) == rows
