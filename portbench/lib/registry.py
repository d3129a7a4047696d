"""Finds a cell's files by name: its configuration (`configs/<config>.json`,
the path under `file` in BENCHMARK.json), its traffic mix
(`traffic/<mix>.json`), the general runner the mix names by its `kind`
(`kinds/<kind>.py`), the program side and the reference of the tier the
configuration names by its `tier` (`tiers/<tier>.py`,
`reference/<tier>.py`) and the readers of its per-layer metrics
(`metrics/<metric>.py`, each with `read(ctx) -> float or None`). Adding a
configuration, a mix, a kind, a tier or a metric adds files; nothing here
changes."""

import importlib.util
import json
import os
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = "portbench"


def _applies(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without a list: wherever what it moves is
    # reported; an end-to-end metric without one: everywhere
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(workload, root=ROOT):
    """The cell `workload`: its names, configuration, mix, chips and the
    metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           f"{cell['traffic']}.json")) as f:
        mix = json.load(f)
    everywhere = {m["name"] for m in bench["end_to_end"]}
    e2e = [m for m in bench["end_to_end"]
           if _applies(m, workload, everywhere)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, e2e_names)]
    return SimpleNamespace(name=workload, config=config, mix=mix,
                           chips=int(cell["chips"]), end_to_end=e2e,
                           per_layer=per_layer, root=root)


def _module(folder, name, root):
    """The module of the file `<folder>/<name>.py` under the benchmark's
    directory of `root`."""
    path = os.path.join(root, BENCH_DIR, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {folder}/{name}.py under {root}/{BENCH_DIR}")
    tag = f"{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name, root=ROOT):
    """`read` of `metrics/<name>.py`."""
    return _module("metrics", name, root).read


def kind(name, root=ROOT):
    """The general runner `kinds/<name>.py` (its `Runner` and
    `control`)."""
    return _module("kinds", name, root)


def tier(name, root=ROOT):
    """The program side of the tier `tiers/<name>.py`."""
    return _module("tiers", name, root)


def reference(name, root=ROOT):
    """The plain reference of the tier `reference/<name>.py` (`fit`,
    `predict`)."""
    return _module("reference", name, root)
