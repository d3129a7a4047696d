"""BENCHMARK.json against the benchmark's contract, and the result line's
keys, names and units."""

import json
import math
import os
import re

from portbench.lib import harness, registry
from portbench.tests import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(registry.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32
    assert all(TEXT.match(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch")
    assert b["command"][1].startswith(b["paths"][0] + "/")
    # a full check of 24 cells must fit: 2 + 14 runs a cell, each with
    # run_seconds + 60, 2 x 90 s a cell to compile, 1,200 s spare
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_entries_names_units_and_keys():
    b = bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    cell_names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert os.path.exists(os.path.join(
            registry.ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
        cell_names.add(w["name"])
    assert len(cell_names) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert os.path.exists(os.path.join(
            registry.ROOT, "portbench", "metrics", f"{m['name']}.py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cell_names
    for w in cell_names:
        cell = registry.load_cell(w)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        assert harness.runner_for(cell).Runner
        assert registry.reference(cell.config["tier"]).fit


def test_result_line_keys(tmp_path):
    res = cells.run(cells.SERVE, tmp_path)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert set(res["metrics"]) == {"estimates_per_s", "request_p95_ms",
                                   "setup_s"}
    for name, m in res["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert math.isfinite(m["value"]) and m["value"] > 0
    for name, item in res["check"].items():
        assert NAME.match(name) and set(item) == {"value", "limit"}
    json.dumps(res)
