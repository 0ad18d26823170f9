"""The knee of an open-loop cell: run it at each of a few arrival rates in
one process and print, for each, the requests due, failed, the TTFT tail,
the queue depth at the window's middle and end and the output tokens/s.

    python3 portbench/sweep.py --workload qwen2-0.5b.chat-prefix --seed 7 \
        --seconds 30 --rates 1 1.5 2 3 4 6

The knee is the highest rate whose backlog does not grow: the queue at the
window's end no deeper than at its middle, and every due request has its
first token within the drain.  The cell runs at about four fifths of it;
its file holds that rate as a number."""
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

from portbench.harness import runner, stats  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    rows = []
    for rate in args.rates:
        res, run = runner.run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                                   t_proc=time.perf_counter(),
                                   mix_overrides={"rate": rate})
        ttft = run.ttft_ms()
        row = {"rate": rate, "due": res["attempted"], "failed": res["failed"],
               "ttft_p50_ms": stats.percentile(ttft, 50),
               "ttft_p90_ms": stats.percentile(ttft, 90),
               "itl_p95_ms": stats.percentile(run.token_gaps_ms(), 95),
               "queue_mid": run.queue_mid, "queue_end": run.queue_end,
               "output_tokens_per_s": run.window_tokens() / run.seconds,
               "sustained": res["failed"] == 0 and run.queue_end <= run.queue_mid,
               "checks": res["checks"], "correct": res["correct"]}
        rows.append(row)
        print("[sweep] " + json.dumps(row), flush=True)
    ok = [r["rate"] for r in rows if r["sustained"]]
    print("[sweep] knee " + json.dumps({"knee_rate": max(ok) if ok else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
