"""Tiny sizes of the two cells that a CPU test run can hold, and a runner
through the harness (its look for a card skipped)."""

import time

from portbench.lib import harness, registry

SERVE = "synth6-exact-fp64.plan-sessions"
REFIT = "synth6big-nystrom-high.refit"
TINY = {
    SERVE: ({"train_rows": 400, "pad_slots": 64, "check_answers": 512},
            {"sessions": 4, "lines_max": 32}),
    REFIT: ({"log_rows": 2400, "window_rows": 1600, "num_inducing": 128,
             "panel_rows": 512, "check_rows": 512}, {}),
}
SEED = 2 ** 31 + 12345


def run(workload, tmp_path, seconds=1.0, seed=SEED, root=registry.ROOT,
        program=None, config=None, device="cpu"):
    """The result object of one tiny run of `workload`."""
    cell = registry.load_cell(workload, root)
    over, mix = TINY[workload]
    return harness.run_cell(cell, seed, seconds, 0, device,
                            time.perf_counter(), str(tmp_path),
                            config_overrides=dict(over, **(config or {})),
                            mix_overrides=mix, program=program)
