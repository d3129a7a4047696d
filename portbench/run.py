"""Run one cell of the benchmark of nngp_tpu_torch on this machine's
card(s):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints progress and the compared numbers on standard error, and as the
last line of standard output one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and check last. Exits non-zero
with no result when there is no CUDA card or too few for the cell.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:], T_START)
