"""Training loop, the reference's ``training/train_loop.py``: auto-resume,
periodic async checkpoints, failure hooks.

``Trainer.run`` is restart-idempotent: killing the process at any step and
re-running resumes from the last committed checkpoint and replays the
deterministic data stream from there — the tests assert the loss
trajectory is identical to an uninterrupted run.

The weights are the port's own seeded ``params.init``, drawn on the
trainer's device; they differ from the reference's draws (ROADMAP §3).
``params`` starts from given weights instead (the parity tests pass the
reference's through ``from_jax``).  Checkpoints are the reference's: each
package's ``Trainer`` resumes from the other's.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import BigramStream, DataConfig
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.steps import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    ckpt_every: int = 10
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    seed: int = 0
    log_every: int = 10
    async_ckpt: bool = True


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 dcfg: DataConfig = DataConfig(),
                 perf: PerfConfig = BASELINE,
                 opt: AdamWConfig = AdamWConfig(),
                 fail_at_step: int | None = None,
                 device=None, params=None):
        """``device``: the GPU unless the CPU is asked for."""
        self.cfg, self.tcfg, self.dcfg = cfg, tcfg, dcfg
        self.device = resolve_device(device)
        self.model, self._step_fn = make_train_step(cfg, perf, opt)
        self.data = BigramStream(cfg, dcfg, self.device)
        self.saver = CKPT.AsyncSaver()
        self.fail_at_step = fail_at_step
        self.losses: list[float] = []

        specs = self.model.param_specs()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = P.init(gen, specs, self.device)
        self.params = params
        self.opt_state = init_opt_state(specs, self.device)
        self.start_step = 0
        steps = CKPT.list_steps(tcfg.ckpt_dir)
        if steps:
            restored, manifest = CKPT.restore_state(
                tcfg.ckpt_dir, steps[-1], {"params": self.params, "opt": self.opt_state},
                cfg, self.device)
            self.params, self.opt_state = restored["params"], restored["opt"]
            self.start_step = manifest["step"]

    def run(self, on_step: Callable[[int, dict], None] | None = None) -> list[float]:
        t0 = time.time()
        for step in range(self.start_step, self.tcfg.steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.saver.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.data.batch(step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            self.losses.append(loss)
            if on_step:
                on_step(step, metrics)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == self.tcfg.steps:
                tree = CKPT.reference_layout({"params": self.params,
                                              "opt": self.opt_state}, self.cfg)
                meta = {"loss": loss, "wall_s": time.time() - t0}
                if self.tcfg.async_ckpt:
                    self.saver.save(self.tcfg.ckpt_dir, step + 1, tree, meta)
                else:
                    CKPT.save(self.tcfg.ckpt_dir, step + 1, tree, meta)
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"step {step+1}: loss {loss:.4f}", flush=True)
        self.saver.wait()
        return self.losses
