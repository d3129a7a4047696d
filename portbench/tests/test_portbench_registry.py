"""A configuration, a traffic mix, a traffic kind, a tier and a per-layer
metric are added by adding files: the harness finds them by the names in
BENCHMARK.json, the mix's `kind` and the configuration's `tier`."""

import json
import os
import shutil
from types import SimpleNamespace

from portbench.lib import registry
from portbench.tests import cells


def checkout(tmp_path):
    """A copy of the benchmark's files, and BENCHMARK.json as read."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(registry.ROOT, "portbench"),
                    root / "portbench")
    os.symlink(os.path.join(registry.ROOT, "workloads"), root / "workloads")
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        return root, json.load(f)


def add_cell(root, bench, config, traffic, why="a test"):
    name = f"{config}.{traffic}"
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": why})
    if not any(c["name"] == config for c in bench["configs"]):
        bench["configs"].append({
            "name": config, "source": "https://github.com/Kangfei/NNGP-src",
            "file": f"portbench/configs/{config}.json", "reduced": [],
            "why": why})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return name


def test_new_files_are_found_with_no_edit(tmp_path):
    root, bench = checkout(tmp_path)
    # a new configuration: the serving one with another ridge
    with open(root / "portbench/configs/synth6-exact-fp64.json") as f:
        config = json.load(f)
    config.update(name="synth6-exact-fp64-ridge", diag_reg=1e-2)
    with open(root / "portbench/configs/synth6-exact-fp64-ridge.json",
              "w") as f:
        json.dump(config, f)
    # a new mix: fewer, shorter sessions
    with open(root / "portbench/traffic/plan-sessions.json") as f:
        mix = json.load(f)
    mix.update(sessions=2, lines_max=16)
    with open(root / "portbench/traffic/plan-short.json", "w") as f:
        json.dump(mix, f)
    # a new per-layer metric
    with open(root / "portbench/metrics/requests.serve.py", "w") as f:
        f.write("def read(ctx):\n    return float(ctx.counts['requests'])\n")
    cell = "synth6-exact-fp64-ridge.plan-short"
    bench["configs"].append({
        "name": config["name"], "source": config["source"],
        "file": "portbench/configs/synth6-exact-fp64-ridge.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": "plan-short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "requests.serve", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "batcher",
        "moves": "estimates_per_s", "workloads": [cell]})
    for m in bench["end_to_end"]:
        if m["name"] in ("estimates_per_s", "request_p95_ms"):
            m["workloads"].append(cell)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    found = registry.load_cell(cell, str(root))
    assert found.config["diag_reg"] == 1e-2 and found.mix["sessions"] == 2
    assert [m["name"] for m in found.per_layer] == ["requests.serve"]
    read = registry.metric_reader("requests.serve", str(root))
    assert read(SimpleNamespace(counts={"requests": 7})) == 7.0
    cells.TINY[cell] = (cells.TINY[cells.SERVE][0], {})
    try:
        res = cells.run(cell, tmp_path, root=str(root))
    finally:
        del cells.TINY[cell]
    assert res["correct"], res["check"]
    assert res["attempted"] > 0


KIND = """
from portbench.kinds import closed_sessions


class Runner(closed_sessions.Runner):
    \"\"\"Closed sessions, each request's lines sent in reverse.\"\"\"

    def setup(self):
        super().setup()
        self.pool = self.pool[::-1]
        self.counts["kind"] = "reversed_sessions"


control = closed_sessions.control
"""


def test_a_new_kind_and_a_config_of_another_tier_are_files_only(tmp_path):
    """A traffic kind of its own (kinds/<kind>.py), and the exact tier on
    the rolling refit mix: a configuration file, no code."""
    root, bench = checkout(tmp_path)
    (root / "portbench/kinds/reversed_sessions.py").write_text(KIND)
    with open(root / "portbench/traffic/plan-sessions.json") as f:
        mix = json.load(f)
    mix["kind"] = "reversed_sessions"
    with open(root / "portbench/traffic/plan-reversed.json", "w") as f:
        json.dump(mix, f)
    with open(root / "portbench/configs/synth6big-nystrom-high.json") as f:
        config = json.load(f)
    config.update(name="synth6big-exact-fp64", tier="exact",
                  dtype="float64", chunk_norm=False,
                  control={"config": {"dtype": "float32"}},
                  limits={"mean_gap": 1e-4, "std_gap": 1e-4,
                          "mean_gap_median": 1e-5, "std_gap_median": 1e-5})
    with open(root / "portbench/configs/synth6big-exact-fp64.json",
              "w") as f:
        json.dump(config, f)
    served = add_cell(root, bench, "synth6-exact-fp64", "plan-reversed")
    refits = add_cell(root, bench, "synth6big-exact-fp64", "refit")
    for m in bench["end_to_end"]:
        if m["name"] in ("estimates_per_s", "request_p95_ms"):
            m["workloads"].append(served)
        if m["name"] == "refit_ms":
            m["workloads"].append(refits)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    cells.TINY[served] = cells.TINY[cells.SERVE]
    cells.TINY[refits] = cells.TINY[cells.REFIT]
    try:
        res = cells.run(served, tmp_path, root=str(root))
        assert res["correct"], res["check"]
        res = cells.run(refits, tmp_path, root=str(root))
        assert res["correct"], res["check"]
        assert set(res["metrics"]) == {"refit_ms", "setup_s"}
        cell = registry.load_cell(refits, str(root))
        over, program = registry.kind("rolling_refit",
                                      str(root)).control(cell.config)
        res = cells.run(refits, tmp_path, root=str(root), config=over,
                        program=program)
        assert not res["correct"], res["check"]
    finally:
        del cells.TINY[served], cells.TINY[refits]
