"""Run one cell of the port's benchmark and print its result as the last
line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced run.  The cells are in ``BENCHMARK.json``.
"""
import time

T_PROC = time.perf_counter()     # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import env  # noqa: E402

env.prepare(ROOT)

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_PROC))
