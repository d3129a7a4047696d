"""The readings a cell's limits are set from: the compared numbers of the
program on many seeds, of the cell's lower-precision control and of
planted faults on a few, in one process at a short window at the cell's
own size and load.

    python3 portbench/control.py --workload <cell> \
        --side program=1,2,... --side control=7,8,9 \
        --side stale_fit=10,11,12 --seconds 5

prints one JSON line a run: {"side", "seed", "readings" (every number
the check read, those with no limit too), "correct", "metrics"}.
`control` is the configuration's (the kind's `control()`): the program's
own path in the next precision below the configuration's where it has
one, else the reference computed so; any other side is a function of
`planted.py`. Not run by the benchmark's own runs.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import planted  # noqa: E402
from portbench.lib import harness, registry  # noqa: E402


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--side", action="append", default=[],
                   help="<program|control|planted function>=<seeds>")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_env(registry.ROOT)
    cell = registry.load_cell(args.workload)
    runs = []
    for item in args.side:
        side, seeds = item.split("=", 1)
        if side == "program":
            over, program = {}, None
        elif side == "control":
            over, program = harness.runner_for(cell).control(cell.config)
        else:
            over, program = {}, getattr(planted, side)
        runs += [(side, int(s), over, program) for s in seeds.split(",")]
    for side, seed, over, program in runs:
        readings = {}
        res = harness.run_cell(cell, seed, args.seconds, 0, args.device,
                               time.perf_counter(), harness.scratch_dir(),
                               config_overrides=over, program=program,
                               all_readings=readings)
        print(json.dumps({"side": side, "seed": seed,
                          "readings": readings,
                          "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
