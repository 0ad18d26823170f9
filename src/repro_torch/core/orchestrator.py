"""Orchestrator: the full cloud-native control loop over real engines.

Ties the six paper modules together for a replica set of
:class:`InferenceEngine` instances (each one a model replica, as Kubernetes
would run one pod per replica):

  profiler   <- per-step engine telemetry
  predictor  -> arrival-rate forecast
  autoscaler -> replica count (HPA law, cold start = engine build time)
  balancer   -> request routing across replicas
  migration  -> drain/rebalance live requests

The same loop drives the simulator through ``SimCluster`` (benchmarks) —
this module is the *real-engine* backend used by examples and tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.core.autoscaler import Autoscaler, HPAConfig
from repro_torch.core.cache_directory import ClusterCacheDirectory
from repro_torch.core.loadbalancer import LoadBalancer
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.migration import MigrationConfig, MigrationManager
from repro_torch.core.predictor import make_predictor
from repro_torch.core.profiler import Profiler
from repro_torch.core.scaling_policy import (ProactiveConfig,
                                       ProactiveScalingPolicy,
                                       ScalingSignals)
from repro_torch.core.tracing import Tracer, attribute_slo_misses
from repro_torch.core.transport import (DirectoryTransportClient,
                                  DirectoryTransportService, Transport)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request


@dataclasses.dataclass
class OrchestratorConfig:
    # endpoint identity: non-empty when this orchestrator is one endpoint of
    # an EndpointRegistry.  It prefixes transport node names and profiler
    # targets and becomes the {endpoint=...} metric label, so several
    # orchestrators can share one Transport and one MetricsRegistry.
    name: str = ""
    # min_replicas=0 enables scale-to-zero: the endpoint starts with no
    # engines, spins one up on first request (spawn_replica), and
    # idle_ticks_to_zero control ticks with nothing pending tear the
    # replica set back down.  The HPA never proposes 0 (K8s law floors at
    # 1), so zero-scale is orchestrator policy, not autoscaler output.
    min_replicas: int = 1
    max_replicas: int = 4
    # control ticks with pending()==0 before a min_replicas=0 endpoint
    # tears down to zero replicas.  0 disables idle teardown.
    idle_ticks_to_zero: int = 0
    hpa: HPAConfig = dataclasses.field(default_factory=lambda: HPAConfig(
        metric="queue", target=4.0, max_replicas=4, stabilization_s=5.0,
        scale_down_cooldown_s=5.0))
    migration: MigrationConfig = dataclasses.field(default_factory=MigrationConfig)
    lb_policy: str = "least"
    lb_seed: int = 0                # p2c sampling seed (bench reproducibility)
    # "directory" load blend: cached tokens one unit of pending() load is
    # worth — larger sticks harder to warm replicas, smaller spills sooner
    directory_load_weight: float = 4.0
    control_every_steps: int = 4
    predictor: str = "holt"
    cold_start_steps: int = 0       # extra steps before a new replica serves
    # proactive goodput-driven scaling: when set, desired replica counts
    # come from a ProactiveScalingPolicy (forecast arrivals at the warm-up
    # horizon over a learned capacity model, arbitrated by SLO goodput)
    # instead of the reactive HPA ratio law.  The HPA behaviors
    # (min/max clamp, stabilization, cooldowns) in cfg.hpa still apply.
    scaling: ProactiveConfig | None = None
    # cluster cache directory: full-state anti-entropy every N control ticks
    # (deltas stream continuously; reconciliation repairs lost events and
    # orphaned radix descendants).  0 disables periodic reconciliation.
    directory_reconcile_every: int = 4
    # simulated cluster transport (core/transport.py).  None keeps the
    # in-process fabric: directory deltas mutate the directory
    # synchronously and migrations move whole payloads in one call.  With
    # a Transport, directory deltas/reconciles become messages on the
    # step clock — routing sees the stale *delivered* view, and injected
    # faults exercise the conservative-subset invariant — and
    # rebalance/drain migrations stream block-granular chunks over the
    # replica links, overlapped with compute on both ends.  Node names:
    # replicas are "r{lb_id}", the control plane is "ctrl", both prefixed
    # "{name}/" when this orchestrator is a named endpoint sharing the
    # fabric with others.
    transport: Transport | None = None


class Orchestrator:
    def __init__(self, make_engine: Callable[[], InferenceEngine],
                 cfg: OrchestratorConfig = OrchestratorConfig(),
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.cfg = cfg
        self.make_engine = make_engine
        self._next_lb_id = 0
        # endpoint label ("default" for a bare orchestrator — metric labels
        # never carry empty strings) and the prefix that namespaces this
        # endpoint's transport nodes / profiler targets on shared fabric
        self._ep = cfg.name or "default"
        self._prefix = f"{cfg.name}/" if cfg.name else ""
        # cluster-wide observability: one Tracer + one MetricsRegistry that
        # every replica is rebound onto at spawn, so a migrated request's
        # spans land in one trace and the exposition covers the whole plane.
        # The registry passes shared instances; standalone use builds its own.
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._g_replicas = self.metrics.gauge(
            "cluster_replicas", "Live replica count", ("endpoint",))
        self._g_dir_entries = self.metrics.gauge(
            "directory_entries", "Cluster cache-directory entries",
            ("endpoint",))
        self._g_dir_chains = self.metrics.gauge(
            "directory_distinct_chains", "Distinct chains in the directory",
            ("endpoint",))
        self._c_dir = self.metrics.counter(
            "directory_events_total",
            "Directory lifecycle events (inserts / evicts / reconciles / "
            "repairs)", ("kind", "endpoint"))
        # cluster-level prefix-cache directory: every paged replica's index
        # deltas stream into it; the "directory" LB policy routes on it
        self.directory = ClusterCacheDirectory()
        # optional simulated network: the directory's delta/reconcile
        # traffic and the migration KV chunks ride it when configured
        self.transport = cfg.transport
        self._dir_clients: dict[int, DirectoryTransportClient] = {}
        if self.transport is not None:
            self._dir_service = DirectoryTransportService(self.directory)
            self._dir_service.bind(self.transport, f"{self._prefix}ctrl")
            self.transport.attach_metrics(self.metrics)
        # registry hook: called before each autoscaler-driven spawn; a False
        # return vetoes it (the EndpointRegistry enforces the cluster-wide
        # replica budget and priority eviction through this)
        self.replica_gate: Callable[[], bool] | None = None
        self._idle_ticks = 0
        self.engines: list[InferenceEngine] = [self._spawn()
                                               for _ in range(cfg.min_replicas)]
        self._cold: dict[int, int] = {}
        self.profiler = Profiler(registry=self.metrics)
        # proactive goodput policy: a per-endpoint planner whose horizon
        # covers the replica warm-up lag, fed below with arrival/outcome
        # signals sampled on the control-tick clock
        self.scaling = None
        if cfg.scaling is not None:
            self.scaling = ProactiveScalingPolicy(
                cfg.scaling, cold_start_steps=cfg.cold_start_steps,
                control_every_steps=cfg.control_every_steps, name=self._ep)
            self.scaling.attach_metrics(self.metrics, endpoint=self._ep)
        self.autoscaler = Autoscaler(cfg.hpa, make_predictor(cfg.predictor),
                                     policy=self.scaling)
        self.autoscaler.attach_metrics(self.metrics, endpoint=self._ep)
        self.balancer = LoadBalancer(cfg.lb_policy, seed=cfg.lb_seed,
                                     directory=self.directory,
                                     directory_load_weight=cfg.directory_load_weight)
        self.balancer.attach_metrics(self.metrics)
        self.migrations = MigrationManager(cfg.migration)
        self.migrations.attach_metrics(self.metrics)
        self._steps = 0
        self._controls = 0
        # goodput-loop accounting: tokens served since the last control
        # tick, the tick's step stamp, and the rids already scored against
        # their SLOs (each finished request is scored exactly once)
        self._served_tokens = 0
        self._last_control_step = 0
        self._scored_rids: set[int] = set()
        self.scale_history: list[tuple[float, int]] = []
        # requests that completed on replicas since retired by scale-down
        self.finished: list[Request] = []
        # cluster-wide event stream: every replica's per-step events plus
        # migration transitions, in step order — a migrated request's tokens
        # keep flowing here from its new replica with no gap.  Consumers
        # (serving/api.py, benches) take them via drain_events().
        self.events: list = []

    def _spawn(self) -> InferenceEngine:
        """Create a replica with a stable monotonic identity: prefix-affinity
        rendezvous hashing and the cache directory key on it, so routing is
        reproducible and membership churn remaps only the departed replica's
        keys."""
        eng = self.make_engine()
        eng.lb_id = self._next_lb_id
        self._next_lb_id += 1
        # label hygiene on shared registries: two endpoints both have an
        # r0 — the endpoint prefix keeps their {replica=...} series apart
        eng.replica_label = f"{self._prefix}{eng.lb_id}"
        eng.set_tracer(self.tracer)
        eng.set_metrics(self.metrics)
        if self.transport is None:
            eng.attach_cache_directory(self.directory, eng.lb_id)
        else:
            # the replica publishes into a transport client, not the
            # directory object: its deltas become unreliable messages and
            # the control plane's view goes stale by (at least) link latency
            client = DirectoryTransportClient(self.transport,
                                              f"{self._prefix}r{eng.lb_id}",
                                              f"{self._prefix}ctrl")
            self._dir_clients[eng.lb_id] = client
            eng.attach_cache_directory(client, eng.lb_id)
        return eng

    # ------------------------------------------------------------- routing
    def submit(self, req: Request, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        # label hygiene: per-tenant metrics/quotas key on this — never let
        # an unset tenant reach the label plane as an empty string
        if req.tenant is None:
            req.tenant = "default"
        self._idle_ticks = 0
        if self.scaling is not None:
            # arrival work signal for the forecaster: what serving this
            # request will cost end to end, in tokens
            self.scaling.note_arrival(
                now, len(req.prompt) + req.sampling.max_new_tokens)
        if not self.engines:
            # scale-to-zero wakeup: first request after idle teardown spins
            # a replica up; the request queues behind its cold start below
            self.spawn_replica(now)
        live = [e for i, e in enumerate(self.engines) if self._cold.get(i, 0) <= 0]
        if not live:
            # every replica is still cold-starting: queue rather than
            # reject — the scheduler holds the request until the replica
            # warms and its first step admits it
            live = list(self.engines)
        key, tokens = None, None
        bs = getattr(live[0], "block_size", 16) if live else 16
        if self.balancer.policy == "prefix":
            # route by the prompt's first KV block so requests sharing a
            # system prefix land where its blocks are already cached
            key = tuple(req.prompt[:bs])
        elif self.balancer.policy == "directory":
            # route by the directory's cluster radix view of the *whole*
            # prompt: the replica with the deepest cached overlap wins
            # unless the load blend says it is too hot
            tokens = req.prompt
        eng = self.balancer.pick(live, load=lambda e: e.pending(),
                                 affinity_key=key, tokens=tokens,
                                 block_size=bs)
        if tokens is not None and getattr(eng, "paged", False) \
                and getattr(eng, "prefix_enabled", False):
            # routing intent: same-prefix requests arriving before this one
            # retires (and commits its blocks) co-locate with it instead of
            # scattering by load.  Gated to engines that publish into the
            # directory — an engine that never commits or reconciles must
            # not accrue phantom-overlap intents either.
            self.directory.announce(eng.lb_id, tokens, bs)
        req.replica = self.engines.index(eng)
        eng.submit(req, now)

    # ------------------------------------------------------------- control
    def _control(self, now: float) -> None:
        depth = sum(e.scheduler.depth() for e in self.engines)
        occ = sum(e.pool.used for e in self.engines)
        self.profiler.observe_util(f"{self._prefix}cluster", now,
                                   occ / max(1, sum(e.capacity for e in self.engines)))
        # KV-memory pressure: per-block on paged replicas (real bytes held),
        # per-row on dense — an autoscaler signal alongside queue depth
        cur = len(self.engines)
        kv = sum(e.kv_utilization() for e in self.engines) / max(cur, 1)
        self.profiler.observe_util(f"{self._prefix}cluster/kv", now, kv)
        metric = kv if self.cfg.hpa.metric == "kv_util" else float(depth)
        signals = None
        if self.scaling is not None:
            # snapshot for the proactive policy: queue backlog in work
            # tokens, tokens served since the last tick, warm replicas —
            # all on the logical step clock
            qtok = sum(len(r.prompt) + r.sampling.max_new_tokens
                       for e in self.engines for r in e.scheduler.queue)
            signals = ScalingSignals(
                queue_depth=depth, queue_tokens=qtok,
                served_tokens=self._served_tokens,
                steps=max(self._steps - self._last_control_step, 1),
                warm_replicas=self.warm_replicas(), total_replicas=cur)
            self._served_tokens = 0
            self._last_control_step = self._steps
            # goodput loop: score requests that finished since the last
            # tick and attribute their SLO misses (PR 6's training signal)
            fresh = [r for r in self._iter_finished()
                     if r.rid not in self._scored_rids]
            if fresh:
                self._scored_rids.update(r.rid for r in fresh)
                with_slo = [r for r in fresh
                            if r.slo_ttft is not None
                            or r.slo_tpot is not None]
                rows = attribute_slo_misses(self.tracer, with_slo) \
                    if with_slo else []
                self.scaling.observe_outcomes(fresh, rows)
        # a scaled-to-zero endpoint is invisible to the HPA: the K8s law
        # floors desired at 1, so evaluating at cur=0 would resurrect the
        # endpoint with no demand.  Wakeup happens in submit().
        new = self.autoscaler.evaluate(now, cur, metric, signals=signals) \
            if cur > 0 else 0
        if new > cur:
            spawned = 0
            for i in range(new - cur):
                if self.replica_gate is not None and not self.replica_gate():
                    break       # cluster replica budget exhausted
                self.engines.append(self._spawn())
                self._cold[len(self.engines) - 1] = self.cfg.cold_start_steps
                spawned += 1
            if spawned:
                self.scale_history.append((now, len(self.engines)))
        elif new < cur:
            # retire emptiest engines; migrate their live requests out first.
            # An engine that cannot be fully drained (targets full) survives
            # until a later tick — requests are never dropped.
            victims = sorted(range(cur), key=lambda i: self.engines[i].pool.used)
            victims = victims[: cur - new]
            keep = [i for i in range(cur) if i not in victims]
            removed = []
            for v in victims:
                self._drain(v, keep, now)
                if self.engines[v].pool.used == 0 and \
                        self.engines[v].scheduler.depth() == 0:
                    removed.append(v)
            self._remove_replicas(removed, now)

        # knative-style scale-to-zero: a min_replicas=0 endpoint with
        # nothing queued, running, or in flight for idle_ticks_to_zero
        # consecutive control ticks tears its whole replica set down (the
        # replicas are empty, so removal needs no drain)
        if self.cfg.idle_ticks_to_zero and self.cfg.min_replicas == 0 \
                and self.engines:
            if self.pending() == 0:
                self._idle_ticks += 1
                if self._idle_ticks >= self.cfg.idle_ticks_to_zero:
                    self._remove_replicas(list(range(len(self.engines))), now)
                    self._idle_ticks = 0
            else:
                self._idle_ticks = 0

        # load-imbalance migration between kept engines.  Moves sharing a
        # link split its bandwidth, so the modeled duration of each stretches
        # by the link's planned transfer count (the async path measures
        # contention instead — the transport serializes chunks fairly)
        if len(self.engines) >= 2:
            occs = [e.pool.used / e.capacity for e in self.engines]
            moves = self.migrations.plan(occs)
            link_load: dict[tuple[int, int], int] = {}
            for mv in moves:
                link_load[mv] = link_load.get(mv, 0) + 1
            for src, dst in moves:
                rid = self.migrations.pick_request(self.engines[src])
                if rid is not None:
                    self._migrate(src, dst, rid, now,
                                  concurrent=link_load[(src, dst)])

        # dst-full refusals whose backoff elapsed: re-plan each toward the
        # coolest replica holding room (capped exponential backoff —
        # a refusal re-arms the timer with a doubled delay)
        for rid in self.migrations.ready_to_retry(now):
            holder = next((i for i, e in enumerate(self.engines)
                           if any(r.rid == rid
                                  for r in e.migratable_requests())), None)
            if holder is None:
                self.migrations.clear_retry(rid)   # finished or requeued
                continue
            targets = sorted(
                (i for i in range(len(self.engines)) if i != holder),
                key=lambda i: self.engines[i].pool.used
                / self.engines[i].capacity)
            if targets:
                self._migrate(holder, targets[0], rid, now)

        # cache-directory anti-entropy + telemetry: deltas stream on every
        # index mutation; the periodic full-state reconcile repairs what
        # they can miss (orphaned radix descendants, detached sinks)
        self._controls += 1
        every = self.cfg.directory_reconcile_every
        if every and self._controls % every == 0:
            for e in self.engines:
                # over the transport the reconcile snapshot is itself a
                # message — it repairs the directory only when it survives
                # the link (and the next one repairs what this one misses)
                sink = self._dir_clients.get(e.lb_id, self.directory)
                e.reconcile_cache_directory(sink)
        # gauge, not a token counter: the util store is a plain windowed
        # float series, which is what an absolute entry count needs
        # (observe_tokens would turn it into a bogus tokens/s rate)
        self.profiler.observe_util(f"{self._prefix}cluster/directory_entries",
                                   now, float(self.directory.total_entries))
        # cluster + directory exposition (pegged: DirectoryStats keeps its
        # own cumulative counts)
        self._g_replicas.set(len(self.engines), endpoint=self._ep)
        self._g_dir_entries.set(self.directory.total_entries,
                                endpoint=self._ep)
        self._g_dir_chains.set(self.directory.distinct_chains,
                               endpoint=self._ep)
        ds = self.directory.stats
        for kind in ("inserts", "evicts", "reconciles", "stale_dropped",
                     "missed_added", "lookups"):
            self._c_dir.peg(getattr(ds, kind), kind=kind, endpoint=self._ep)

    def _iter_finished(self):
        """Every finished request the cluster currently knows: harvested
        from retired replicas plus each live engine's local list."""
        yield from self.finished
        for e in self.engines:
            yield from e.finished

    def _remove_replicas(self, removed: list[int], now: float) -> None:
        """Shared teardown bookkeeping for scale-down, priority eviction,
        and idle-to-zero: harvest finished requests and last events, detach
        and invalidate the directory, drop transport clients, and re-index
        the cold-start counters of the survivors."""
        if not removed:
            return
        gone = set(removed)
        for i in removed:          # a retired replica's served requests
            self.finished.extend(self.engines[i].finished)
            # harvest the victim's last events (drain-migration preempts)
            # before its engine object is dropped
            self.events.extend(self.engines[i].drain_events())
            # the departing replica's pool dies with it — the directory
            # must stop routing to it.  drop_replica directly (not only via
            # the sink detach): intents must die even for replicas that
            # never published (dense / prefix-disabled)
            self.engines[i].detach_cache_directory()
            self.directory.drop_replica(self.engines[i].lb_id)
            self._dir_clients.pop(self.engines[i].lb_id, None)
        keep = [i for i in range(len(self.engines)) if i not in gone]
        self._cold = {n: self._cold[o] for n, o in enumerate(keep)
                      if self._cold.get(o, 0) > 0}
        self.engines = [self.engines[i] for i in keep]
        self.scale_history.append((now, len(self.engines)))

    # --------------------------------------------------- registry surface
    def spawn_replica(self, now: float) -> float:
        """Spin up one replica outside the autoscaler loop (scale-to-zero
        wakeup, registry placement).  Returns the wall-clock seconds the
        checkpoint-load + compile path took (`make_engine`), which the
        registry reports as ``cold_start_s``; the logical-clock half of the
        cold start is ``cfg.cold_start_steps`` ticking down in step()."""
        t0 = time.perf_counter()
        self.engines.append(self._spawn())
        wall = time.perf_counter() - t0
        self._cold[len(self.engines) - 1] = self.cfg.cold_start_steps
        self.scale_history.append((now, len(self.engines)))
        return wall

    def warm_replicas(self) -> int:
        """Replicas past their cold start (schedulable right now)."""
        return sum(1 for i in range(len(self.engines))
                   if self._cold.get(i, 0) <= 0)

    def evict_coolest(self, now: float) -> bool:
        """Tear down this endpoint's coolest (emptiest) replica so a
        higher-priority endpoint can use the capacity.  Within the endpoint
        live rows drain to surviving replicas over the migration machinery;
        across endpoints this is plain teardown (models differ — KV can't
        migrate).  The last replica is only evicted when idle: a victim
        still holding work after the drain survives and the eviction
        reports failure."""
        if not self.engines:
            return False
        v = min(range(len(self.engines)),
                key=lambda i: self.engines[i].pool.used)
        keep = [i for i in range(len(self.engines)) if i != v]
        if keep:
            self._drain(v, keep, now)
        vic = self.engines[v]
        if vic.pool.used or vic.scheduler.depth():
            return False
        self._remove_replicas([v], now)
        return True

    def _migrate(self, src_i: int, dst_i: int, rid: int, now: float,
                 concurrent: int = 1) -> bool:
        """One move, on whichever fabric is configured: the synchronous
        whole-payload handoff, or a block-granular async transfer streamed
        over the replicas' transport link (the destination starts serving
        the row as soon as the last chunk lands; both replicas keep
        stepping meanwhile)."""
        src, dst = self.engines[src_i], self.engines[dst_i]
        if self.transport is None:
            ev = self.migrations.migrate(src, dst, rid, now, src_i, dst_i,
                                         concurrent=concurrent)
            return ev is not None
        return self.migrations.migrate_async(
            src, dst, rid, now, self.transport,
            f"{self._prefix}r{src.lb_id}", f"{self._prefix}r{dst.lb_id}",
            src_i, dst_i)

    def _drain(self, victim: int, keep: list[int], now: float) -> None:
        """Move every live request off a scale-down victim: decode rows and
        chunk-boundary mid-prefill rows alike (the payload carries prefill
        progress), on dense and paged replicas (block-table handoff) — paged
        scale-down drains actively instead of by attrition.  A row no target
        can admit survives here and retries next control tick."""
        src = self.engines[victim]
        for rid in [r.rid for r in src.migratable_requests()]:
            for k in keep:
                ok = self._migrate(victim, k, rid, now)
                if ok:
                    break
                if not any(r.rid == rid for r in src.migratable_requests()):
                    break  # rollback requeued it; the loop below resubmits
        # requeue anything still queued
        while src.scheduler.queue:
            req = src.scheduler.queue.popleft()
            self.submit(req, now)

    # ------------------------------------------------------------- stepping
    def step(self, now: float | None = None, *,
             pump_transport: bool = True) -> None:
        now = time.perf_counter() if now is None else now
        pre = f"{self._prefix}engine"
        for i, eng in enumerate(self.engines):
            if self._cold.get(i, 0) > 0:
                self._cold[i] -= 1
                continue
            st = eng.step(now)
            self.events.extend(st.events)
            self._served_tokens += st.tokens_out + st.prefill_tokens_true
            self.profiler.observe_latency(f"{pre}/{i}/decode", now, st.decode_s)
            self.profiler.observe_util(f"{pre}/{i}/kv", now, st.kv_util)
            if st.prefill_tokens:
                self.profiler.observe_latency(f"{pre}/{i}/prefill", now,
                                              st.prefill_s)
                self.profiler.observe_tokens(f"{pre}/{i}/prefill", now,
                                             st.prefill_tokens_true)
                self.profiler.observe_tokens(f"{pre}/{i}/prefill_padded", now,
                                             st.prefill_tokens_padded)
            if st.prefix_hit_tokens:
                self.profiler.observe_tokens(f"{pre}/{i}/prefix_hits", now,
                                             st.prefix_hit_tokens)
        self._steps += 1
        if self._steps % self.cfg.control_every_steps == 0:
            self._control(now)
            # migrations during the control tick emitted on their source
            # engines between steps; surface them in cluster step order
            for e in self.engines:
                self.events.extend(e.drain_events())
        if self.transport is not None:
            # advance the network one step with the cluster: queued KV
            # chunks (re)send under backpressure, due messages deliver —
            # directory deltas apply, finished adoptions commit their rows.
            # On a shared fabric the EndpointRegistry passes
            # pump_transport=False and steps the Transport exactly once per
            # cluster step after every endpoint has pumped its migrations.
            self.migrations.pump(now, self.transport)
            if pump_transport:
                self.transport.step()

    def drain_events(self) -> list:
        """Return and clear the cluster event stream (cross-replica, in
        step order; migration preempts included)."""
        ev, self.events = self.events, []
        return ev

    def pending(self) -> int:
        return sum(e.pending() for e in self.engines)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while self.pending() and max_steps > 0:
            self.step()
            max_steps -= 1
        out = list(self.finished)
        for e in self.engines:
            out.extend(e.finished)
        return out
