"""The command line of a run: ``run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from portbench.harness import guard, runner, spec


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_lines(checks: dict) -> list[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def main(argv, root: Path, t_proc: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(root, args.workload)      # raises without its files
    if not torch.cuda.is_available():
        say("portbench: no CUDA device; this benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"portbench: {args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    result, _ = runner.run_cell(root, args.workload, args.seed, args.seconds,
                                bool(args.trace), t_proc=t_proc)
    bad = guard.forbidden_modules()
    if bad:
        say(f"portbench: the run loaded JAX or the JAX package: {bad}")
        return 3
    for line in check_lines(result["checks"]):
        say(line)
    print(json.dumps(result), flush=True)
    return 0
