"""Whole runs of a cell on the CPU at ``-smoke`` sizes with the kernels'
plain paths, the command line's refusals, and the import guard."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import guard, main
from smoke import CHAT, MOE, ROOT, run


@pytest.mark.parametrize("cell,trace", [(CHAT, False), (CHAT, True), (MOE, False)])
def test_a_whole_run_on_the_cpu_is_correct_and_reports_no_device_metric(cell, trace):
    res, r = run(cell, trace=trace)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "device" not in res and "breakdown" not in res
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sources = {m["name"]: m["source"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert names and all(sources[n] != "device_trace" for n in names)
    if trace:
        assert "prefix_hit_share" in names and "queue_wait_ms.p90" in names
    else:
        assert "setup_s" in names and "itl_p95_ms" in names
    assert res["checks"]["tokens_compared"]["value"] >= 16


def test_the_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main.main(["--workload", CHAT, "--seed", "1", "--seconds", "1", "--trace", "0"],
                   ROOT, 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CHAT, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_guard_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.serving": 1, "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_modules(mods) == []
    mods.update({"repro.models.lm": 1, "jax": 1, "flax.linen": 1})
    assert guard.forbidden_modules(mods) == ["flax.linen", "jax", "repro.models.lm"]


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; from portbench.harness import env; "
            "from pathlib import Path; env.prepare(Path(%r)); "
            "from portbench.harness import runner, main, check, trace; "
            "from portbench.reference import dense, moe; "
            "import repro_torch.serving, repro_torch.models.lm; "
            "from portbench.harness import guard; print(guard.forbidden_modules())"
            ) % (str(ROOT), str(ROOT / "src"), str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_run_on_the_card(cuda):
    """One short run of the smallest cell through the command, on the card."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "qwen2-0.5b.decode-heavy", "--seed", "3", "--seconds", "5",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


test_a_run_on_the_card = pytest.mark.gpu(test_a_run_on_the_card)
