"""Small sizes at which a whole run of a cell fits the CPU tests: a
``-smoke`` arch, a four-row engine and traffic cut to match."""
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CHAT = "qwen2-0.5b.chat-prefix"
MOE = "qwen3-moe-30b-a3b.decode-heavy"
ARCH = {CHAT: "qwen2-0.5b-smoke", MOE: "qwen3-moe-30b-a3b-smoke"}
ENGINE = {"capacity": 4, "max_len": 160, "chunk": 32}
MIX = {
    CHAT: {"prefix": {"count": 2, "tokens": 48, "zipf_s": 1.1}, "rate": 4.0,
           "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40},
           "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2, "max": 16},
           "drain_s": 10},
    MOE: {"clients": 4, "pool": 400, "prompt": {"dist": "uniform", "min": 8, "max": 70},
          "output": {"dist": "uniform", "min": 4, "max": 12}},
}
LIMITS = {"logit_gap_max": 0.05, "tokens_compared": 16}
SEED = 2 ** 31 + 77


def run(cell, seconds=3.0, trace=False, **kw):
    from portbench.harness import runner
    return runner.run_cell(ROOT, cell, kw.pop("seed", SEED), seconds, trace,
                           t_proc=time.perf_counter(), device="cpu", arch=ARCH[cell],
                           engine_overrides=ENGINE, mix_overrides=MIX[cell],
                           limits=LIMITS, **kw)
