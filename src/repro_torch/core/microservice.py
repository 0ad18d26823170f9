"""Fine-grained modularization (paper §3): the model as stage microservices.

A :class:`StagedLM` splits a decoder-only LM into ``num_stages`` contiguous
ranges of the reference's layer groups (``params.group_period`` layers
each; the remainder layers go on the last stage), so ``stage/<i>`` names
the same layers in both packages.  Each stage is a plain function over its
own slice of ``params["layers"]`` and of the per-layer cache list — the
schedulable, scalable, observable unit the paper argues for.  On the card
a stage replica shares the stage's weight tensors; the per-layer gRPC hop
of the paper's Kubernetes prototype becomes a host-side handoff.

:class:`StagePipeline` executes decode steps stage by stage with per-stage
replica sets, per-stage latency profiling, and batch rows split across a
stage's ready replicas — the real-engine backend for the control plane.

Per-stage latency: eager launches return before the card has run them, so
a ``time.perf_counter()`` pair around a stage on CUDA measures its launch,
not the stage.  On CUDA each stage is bracketed by CUDA events, read once
after the step's last launch (one synchronisation a step); on the CPU a
``perf_counter`` pair measures the stage, as in the reference.  Either way
the profiler gets seconds under ``stage/<i>``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.profiler import Profiler
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import LM


def _slice_rows(stage_cache: list, s0: int, s1: int) -> list:
    """Batch-row slice of a stage's per-layer caches (every leaf of every
    kind — attention ``k``/``v``, a ring's ``pos``, SSM ``h`` and conv
    tails — has its batch axis first)."""
    return [{k: t[s0:s1] for k, t in c.items()} for c in stage_cache]


def _concat_rows(stage_caches: list[list]) -> list:
    return [{k: torch.cat([c[i][k] for c in stage_caches]) for k in stage_caches[0][i]}
            for i in range(len(stage_caches[0]))]


class StagedLM:
    def __init__(self, model: LM, num_stages: int):
        if model.cfg.is_encoder_decoder:
            raise ValueError("stage split is decoder-only")
        self.model = model
        cfg = model.cfg
        period = P.group_period(cfg)
        g = cfg.num_layers // period
        num_stages = min(num_stages, g)
        base, rem = divmod(g, num_stages)
        bounds, s = [], 0
        for i in range(num_stages):
            e = s + base + (1 if i < rem else 0)
            bounds.append((s, e))
            s = e
        self.bounds = bounds                  # group ranges per stage
        self.num_stages = num_stages
        # layer ranges: the groups' layers, the tail layers on the last stage
        self.layer_bounds = [(g0 * period, g1 * period) for g0, g1 in bounds]
        self.layer_bounds[-1] = (self.layer_bounds[-1][0], cfg.num_layers)

    # ------------------------------------------------------------- slicing
    def stage_params(self, params, si: int) -> list:
        lo, hi = self.layer_bounds[si]
        return params["layers"][lo:hi]

    def stage_caches(self, caches, si: int) -> list:
        lo, hi = self.layer_bounds[si]
        return caches[lo:hi]

    def merge_caches(self, stage_caches: list[list]) -> list:
        return [c for sc in stage_caches for c in sc]

    # ------------------------------------------------------------- programs
    def embed_fn(self):
        cfg = self.model.cfg

        def f(params_embed, tokens):
            return L.embed_apply(params_embed, tokens, cfg)

        return f

    def head_fn(self):
        model = self.model

        def f(params, x):
            return model._last_logits(params, x, torch.zeros(x.shape[0], dtype=torch.long,
                                                             device=x.device))

        return f

    def stage_fn(self, si: int):
        """Decode step of stage si: (stage_params, x, pos, caches) -> (x,
        new caches); the caches are written in place."""
        model = self.model
        lo = self.layer_bounds[si][0]

        def f(sp, x, pos, sc):
            x, nc, _ = model._trunk({"layers": sp}, x, mode="decode",
                                    positions=pos[:, None], caches=sc, pos=pos, lo=lo)
            return x, nc

        return f


# --------------------------------------------------------------------- pipe
@dataclasses.dataclass
class StageReplica:
    sid: int
    idx: int
    params: Any              # stage param slice (shared tensors)
    ready_at: float = 0.0


class StagePipeline:
    """Decode executor with per-stage replica sets + profiling.

    Batch rows are split across a stage's ready replicas (the paper's
    horizontal-scaling mechanism); per-stage latency (CUDA events on the
    card, wall time on the CPU) feeds the profiler under 'stage/<i>'.
    """

    def __init__(self, model: LM, params, num_stages: int,
                 profiler: Profiler | None = None):
        self.staged = StagedLM(model, num_stages)
        self.params = params
        self.profiler = profiler or Profiler()
        self.replicas: list[list[StageReplica]] = [
            [StageReplica(s, 0, self.staged.stage_params(params, s))]
            for s in range(self.staged.num_stages)]
        self._embed = self.staged.embed_fn()
        self._head = self.staged.head_fn()
        self._stage_fns = [self.staged.stage_fn(s) for s in range(self.staged.num_stages)]

    def scale_stage(self, sid: int, n: int, now: float, cold_start_s: float = 0.0):
        cur = self.replicas[sid]
        while len(cur) < n:
            cur.append(StageReplica(sid, len(cur),
                                    self.staged.stage_params(self.params, sid),
                                    ready_at=now + cold_start_s))
        del cur[n:]

    def decode_step(self, tokens, pos, caches, now: float | None = None):
        """tokens (B,1), pos (B,), the per-layer cache list -> (logits, new
        caches)."""
        now = time.perf_counter() if now is None else now
        x = self._embed(self.params["embed"], tokens)
        cuda = x.device.type == "cuda"
        marks = []                       # per stage: events, or seconds
        new_stage_caches = []
        for si in range(self.staged.num_stages):
            sc = self.staged.stage_caches(caches, si)
            ready = [r for r in self.replicas[si] if r.ready_at <= now]
            ready = ready or self.replicas[si][:1]
            fn = self._stage_fns[si]
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
            if len(ready) == 1:
                x, nc = fn(ready[0].params, x, pos, sc)
            else:
                # split rows across replicas; each runs the same program on
                # its shard (on real hardware these run concurrently)
                B = x.shape[0]
                per = -(-B // len(ready))
                outs, ncs = [], []
                for k, r in enumerate(ready):
                    s0, s1 = k * per, min((k + 1) * per, B)
                    if s0 >= s1:
                        break
                    xs, nck = fn(r.params, x[s0:s1], pos[s0:s1], _slice_rows(sc, s0, s1))
                    outs.append(xs)
                    ncs.append(nck)
                x = torch.cat(outs)
                nc = _concat_rows(ncs)
            if cuda:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
                marks.append((t0, t1))
            else:
                marks.append(time.perf_counter() - t0)
            new_stage_caches.append(nc)
        logits = self._head(self.params, x)
        if cuda:
            marks[-1][1].synchronize()
            marks = [a.elapsed_time(b) / 1e3 for a, b in marks]
        for si, dt in enumerate(marks):
            self.profiler.observe_latency(f"stage/{si}", now, dt)
        return logits, self.staged.merge_caches(new_stage_caches)
