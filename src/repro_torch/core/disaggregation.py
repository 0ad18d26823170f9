"""Prefill/decode disaggregation (DistServe-style, paper §1 landscape).

Separate engine pools for the compute-bound prefill phase and the
memory-bound decode phase: a request is admitted to a prefill engine, runs
its prefill there, then live-migrates (the Llumnix handoff from
core/migration.py) to a decode engine.  Decode engines never run bucketed
prefills, so running decodes are never stalled behind a long prompt — the
TTFT/TPOT interference the paper's §2 calls out.

Handoff point: short (single-chunk) prompts move right after their first
token, as before.  Long chunked prompts move at the **last chunk
boundary** — the payload carries the prefill progress, the decode engine
runs the final (cheap) chunk, and the first token is sampled there, so the
KV transfer starts one chunk earlier and prefill engines emit zero decode
tokens for chunked requests.  Works on dense and paged replicas; paged
handoffs skip blocks the destination's prefix cache already holds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.core.cache_directory import ClusterCacheDirectory
from repro_torch.core.loadbalancer import LoadBalancer
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.migration import MigrationConfig, MigrationManager
from repro_torch.core.tracing import Tracer
from repro_torch.core.transport import Transport
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request, State


@dataclasses.dataclass
class DisaggConfig:
    prefill_engines: int = 1
    decode_engines: int = 1
    # decode-pool routing: "least"/"p2c"/... on kv_utilization, or
    # "directory" — handoffs route to the decode replica whose prefix cache
    # (per the cluster directory) already holds the most of the request's
    # materialised sequence, so migration ships fewer blocks
    lb_policy: str = "least"
    # "directory" load blend, in cached tokens per unit of kv_utilization:
    # the decode-pool load signal is a [0,1] fraction, so the weight must be
    # token-scale for the guard to bite — at 64, a replica 0.25 hotter needs
    # 16 more cached tokens to keep the pick (locality never pins every
    # handoff to one full replica)
    directory_load_weight: float = 64.0
    # hand chunked prompts off at their last chunk boundary instead of
    # waiting for the first token (False restores first-token-only handoff)
    chunk_handoff: bool = True
    migration: MigrationConfig = dataclasses.field(default_factory=MigrationConfig)
    # simulated cluster transport: with one configured, prefill->decode
    # handoffs stream block-granular KV chunks over the inter-pool links
    # ("n{lb_id}" nodes) instead of one synchronous payload copy — the
    # decode engine reserves the row up front and starts serving it the
    # step the last chunk lands, overlapped with both pools' compute
    transport: Transport | None = None


@dataclasses.dataclass
class DisaggStepStats:
    t: float
    handoffs_attempted: int = 0
    handoffs_succeeded: int = 0
    handoffs_failed: int = 0


class DisaggregatedServer:
    def __init__(self, make_engine: Callable[[], InferenceEngine],
                 cfg: DisaggConfig = DisaggConfig()):
        self.cfg = cfg
        self.prefill_pool = [make_engine() for _ in range(cfg.prefill_engines)]
        self.decode_pool = [make_engine() for _ in range(cfg.decode_engines)]
        # decode engines share the first prefill engine's weights (one model)
        for e in self.prefill_pool[1:] + self.decode_pool:
            e.params = self.prefill_pool[0].params
        # stable replica identities + a directory over the decode pool's
        # prefix caches: the decode-routing hook scores handoff targets by
        # cached overlap with the request's materialised sequence
        self.directory = ClusterCacheDirectory()
        # one tracer/registry across both pools: the prefill->decode handoff
        # is mid-request, so its spans must land in one trace
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        for i, e in enumerate(self.prefill_pool + self.decode_pool):
            e.lb_id = i
            e.set_tracer(self.tracer)
            e.set_metrics(self.metrics)
        for e in self.decode_pool:
            e.attach_cache_directory(self.directory, e.lb_id)
        self.balancer = LoadBalancer(cfg.lb_policy, directory=self.directory,
                                     directory_load_weight=cfg.directory_load_weight)
        self.balancer.attach_metrics(self.metrics)
        # the disaggregated transfer is its own span family: "handoff"
        self.migrations = MigrationManager(cfg.migration,
                                           transfer_span="handoff")
        self.migrations.attach_metrics(self.metrics)
        self.finished: list[Request] = []
        self.history: list[DisaggStepStats] = []
        # pool-wide event stream: prefill-engine first tokens, handoff
        # preempts, decode-engine tokens/finishes — one per-request stream
        # across the prefill->decode migration (serving/api.py consumes it)
        self.events: list = []

    def submit(self, req: Request, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        eng = self.balancer.pick(self.prefill_pool, load=lambda e: e.pending())
        eng.submit(req, now)

    def _handoff_ready(self, pe: InferenceEngine) -> list[Request]:
        """Requests a prefill engine should hand to the decode pool now:
        everything that finished prefill (DECODE state), plus — with
        chunk_handoff — mid-prefill rows at a chunk boundary whose
        remaining prompt fits in one final chunk."""
        out = [r for r in pe.row_req.values()
               if r.state is State.DECODE and not r.done()]
        if self.cfg.chunk_handoff:
            for req in pe.migratable_requests():
                if (req.state is State.PREFILL
                        and len(req.prompt) - int(pe.pos[req.row]) <= pe.chunk):
                    out.append(req)
        return out

    def step(self, now: float | None = None) -> DisaggStepStats:
        now = time.perf_counter() if now is None else now
        a0, s0 = self.migrations.attempted, self.migrations.succeeded
        f0 = self.migrations.failed
        for pi, pe in enumerate(self.prefill_pool):
            st = pe.step(now)
            self.events.extend(st.events)
            for req in self._handoff_ready(pe):
                # KV pressure is the real decode-pool signal: occupied rows
                # under-count on paged engines, whose cost is mapped blocks.
                # Directory routing scores the sequence whose KV actually
                # moves, blended against kv_utilization through the
                # token-scale cfg.directory_load_weight
                seq = pe.migration_sequence(req.rid) \
                    if self.balancer.policy == "directory" else None
                dst = self.balancer.pick(self.decode_pool,
                                         load=lambda e: e.kv_utilization(),
                                         tokens=seq,
                                         block_size=getattr(
                                             self.decode_pool[0],
                                             "block_size", 16))
                di = len(self.prefill_pool) + self.decode_pool.index(dst)
                if self.cfg.transport is None:
                    self.migrations.migrate(pe, dst, req.rid, now,
                                            src_idx=pi, dst_idx=di)
                else:
                    # stream the handoff: the decode row activates when the
                    # last chunk lands, prefill keeps stepping meanwhile
                    self.migrations.migrate_async(
                        pe, dst, req.rid, now, self.cfg.transport,
                        f"n{pe.lb_id}", f"n{dst.lb_id}", pi, di)
            # handoff preempts were emitted on the prefill engine between
            # steps; keep them ordered before the decode pool's tokens
            self.events.extend(pe.drain_events())
        for de in self.decode_pool:
            self.events.extend(de.step(now).events)
        if self.cfg.transport is not None:
            self.migrations.pump(now, self.cfg.transport)
            self.cfg.transport.step()
        att = self.migrations.attempted - a0
        ok = self.migrations.succeeded - s0
        # async handoffs may commit steps after their attempt: count only
        # explicit refusals as failures, not transfers still in flight
        st = DisaggStepStats(t=now, handoffs_attempted=att,
                             handoffs_succeeded=ok,
                             handoffs_failed=self.migrations.failed - f0)
        self.history.append(st)
        return st

    def drain_events(self) -> list:
        """Return and clear the pool-wide event stream."""
        ev, self.events = self.events, []
        return ev

    def pending(self) -> int:
        return sum(e.pending() for e in self.prefill_pool + self.decode_pool)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while self.pending() and max_steps > 0:
            self.step()
            max_steps -= 1
        out = []
        for e in self.prefill_pool + self.decode_pool:
            out.extend(e.finished)
        self.finished = out
        return out
