"""The precision control of a cell: for each seed, one run of the cell in
which the check puts the reference computed in float8 in the program's
place and judges the tokens it puts first by the cell's own limits
(``correct``, which has to come out false), with the program's readings
over the same sequences beside them (``program_correct``, ``program_*``).
All seeds in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds 11 12 13

A cell's limit lies above the largest program reading and below the
smallest control reading (``PERF.md`` gives both).  The benchmark's own
runs do not run this."""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import env  # noqa: E402

env.prepare(ROOT)

from portbench.harness import runner  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res, _ = runner.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                 t_proc=time.perf_counter(), control=True)
        print("[control] " + json.dumps({"workload": args.workload, "seed": seed,
                                         "correct": res["correct"],
                                         "program_correct": res["program_correct"],
                                         "checks": res["checks"],
                                         "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
