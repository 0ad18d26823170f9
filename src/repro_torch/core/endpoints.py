"""Model-endpoint registry: multi-model, multi-tenant serving with
scale-to-zero (paper §2 "containerized model services").

One cluster hosts several *endpoints* — model variants with their own
replica sets, cache directories, and autoscaler policies — behind one
control plane.  :class:`ModelEndpoint` is the declarative spec (the
paper's per-service deployment manifest: model config, KV backend,
priority class, replica bounds); :class:`EndpointRegistry` owns one
:class:`~repro_torch.core.orchestrator.Orchestrator` per endpoint while
sharing the things the paper shares cluster-wide:

* one logical step clock — ``registry.step(now)`` advances every
  endpoint and the transport fabric exactly once,
* one :class:`~repro_torch.core.transport.Transport` — endpoints namespace
  their nodes as ``"{name}/r0"``/``"{name}/ctrl"``,
* one Tracer + MetricsRegistry — every series carries an
  ``{endpoint=...}`` label,
* one admission surface with per-tenant quotas
  (:class:`TenantQuota`) — the weighted-fair scheduler policy
  (``SchedulerConfig(policy="wfq")``) divides each replica's admission
  bandwidth by tenant weight.

Scale-to-zero (``min_replicas=0``): the endpoint starts with no
replicas; the first request spawns one (`checkpoint-load + compile`
measured as ``cold_start_s`` wall seconds and ``cold_start_steps``
logical steps, traced as a ``cold_start`` span) and *queues* behind the
warm-up rather than rejecting; ``idle_ticks_to_zero`` quiet control
ticks tear the replica set back down.

Priority classes: under a cluster replica budget, an endpoint that
needs a replica may evict the coolest replica of a *lower-priority*
endpoint — drain/migration inside the victim endpoint, plain teardown
across endpoints (different models: KV cannot migrate).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

from repro_torch.core.autoscaler import HPAConfig
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.core.scaling_policy import ProactiveConfig
from repro_torch.core.tracing import Tracer
from repro_torch.core.transport import Transport
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import SchedulerConfig

# endpoint_state gauge encoding (gauges carry floats, not strings)
STATE_CODES = {"scaled_to_zero": 0, "cold": 1, "ready": 2}


@dataclasses.dataclass
class ModelEndpoint:
    """Declarative endpoint spec — everything the registry needs to run
    one model variant as a replica set.  ``model`` is a
    :class:`~repro_torch.models.ModelConfig` (the default engine factory builds
    :class:`~repro_torch.serving.engine.InferenceEngine` from it); pass
    ``make_engine`` instead for full control of engine construction."""
    name: str
    model: Any = None                       # ModelConfig for the default factory
    make_engine: Callable[[], Any] | None = None
    kv_backend: str = "dense"               # "dense" | "paged"
    # priority class: under a cluster replica budget a higher-priority
    # endpoint may evict a strictly lower-priority endpoint's coolest replica
    priority: int = 0
    min_replicas: int = 1                   # 0 => scale-to-zero endpoint
    max_replicas: int = 4
    hpa: HPAConfig | None = None            # None => queue-depth HPA default
    # proactive goodput-driven scaling (core/scaling_policy.py): when set,
    # this endpoint's desired replica counts come from the forecast +
    # capacity + goodput planner instead of the reactive HPA ratio law
    scaling: ProactiveConfig | None = None
    lb_policy: str = "least"
    sched: SchedulerConfig | None = None    # e.g. policy="wfq" + tenant_weights
    # engine shape (default factory only)
    capacity: int = 4
    max_len: int = 64
    buckets: tuple[int, ...] = (8, 16)
    block_size: int = 16
    seed: int = 7
    # device the default factory builds replicas on (None: the GPU)
    device: Any = None
    # cold start: logical steps a fresh replica warms before serving
    cold_start_steps: int = 2
    # quiet control ticks before a min_replicas=0 endpoint scales to zero
    idle_ticks_to_zero: int = 3
    control_every_steps: int = 4

    def engine_factory(self) -> Callable[[], Any]:
        if self.make_engine is not None:
            return self.make_engine
        if self.model is None:
            raise ValueError(
                f"endpoint {self.name!r}: need a model config or make_engine")
        spec = self

        def make():
            from repro_torch.serving.engine import InferenceEngine
            kw = dict(capacity=spec.capacity, max_len=spec.max_len,
                      buckets=spec.buckets, kv_backend=spec.kv_backend,
                      block_size=spec.block_size, seed=spec.seed,
                      device=spec.device)
            if spec.sched is not None:
                kw["sched"] = dataclasses.replace(spec.sched)
            return InferenceEngine(spec.model, **kw)
        return make


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant admission policy, shared across every endpoint.

    ``weight`` feeds the weighted-fair scheduler (a weight-3 tenant earns
    ~3x the admitted tokens of a weight-1 tenant under saturation);
    ``max_inflight`` hard-caps concurrently live requests — the
    (max_inflight+1)-th submit is rejected with
    ``tenant_rejections_total{reason="quota"}``."""
    weight: float = 1.0
    max_inflight: int | None = None


@dataclasses.dataclass
class _Endpoint:
    """Registry-internal runtime record for one endpoint."""
    spec: ModelEndpoint
    orch: Orchestrator
    cold_rid: int | None = None     # synthetic trace rid of the live cold start
    cold_begin_step: int = 0
    cold_wall_s: float = 0.0


class EndpointRegistry:
    """The multi-model control plane: routes by ``Request.model``, owns
    per-endpoint orchestrators, shares clock/fabric/observability, and
    enforces tenant quotas, priority eviction, and scale-to-zero."""

    def __init__(self, endpoints: tuple[ModelEndpoint, ...] | list = (),
                 *, transport: Transport | None = None,
                 cluster_max_replicas: int | None = None,
                 tenants: dict[str, TenantQuota] | None = None,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.transport = transport
        # cluster-wide replica budget.  None = unbounded: endpoints only
        # honor their own max_replicas and eviction never triggers.
        self.cluster_max_replicas = cluster_max_replicas
        self.tenants: dict[str, TenantQuota] = dict(tenants or {})
        self._eps: dict[str, _Endpoint] = {}
        self._steps = 0
        self._now = 0.0
        # cold-start spans need trace ids that can never collide with real
        # request rids — synthetic negative rids
        self._cold_rids = itertools.count(start=-1, step=-1)
        # quota accounting: live requests per tenant (pruned as they finish)
        self._live: dict[int, Request] = {}
        self._inflight: dict[str, set[int]] = {}
        m = self.metrics
        self._c_requests = m.counter(
            "endpoint_requests_total", "Requests routed, by endpoint/tenant",
            ("endpoint", "tenant"))
        self._g_state = m.gauge(
            "endpoint_state",
            "Endpoint lifecycle (0=scaled_to_zero, 1=cold, 2=ready)",
            ("endpoint",))
        self._c_cold = m.counter(
            "endpoint_cold_starts_total", "Scale-from-zero wakeups",
            ("endpoint",))
        self._g_cold_steps = m.gauge(
            "endpoint_cold_start_steps",
            "Logical steps the last cold start took (spawn -> first warm "
            "replica)", ("endpoint",))
        self._g_cold_s = m.gauge(
            "endpoint_cold_start_seconds",
            "Wall seconds of the last cold start's checkpoint-load + "
            "compile path", ("endpoint",))
        self._c_tenant_rej = m.counter(
            "tenant_rejections_total",
            "Registry-level admission rejections, by tenant",
            ("tenant", "reason"))
        self._c_evict = m.counter(
            "endpoint_evictions_total",
            "Priority evictions: victim's replica torn down for claimant",
            ("victim", "claimant"))
        for spec in endpoints:
            self.add_endpoint(spec)

    # ---------------------------------------------------------- membership
    def add_endpoint(self, spec: ModelEndpoint) -> Orchestrator:
        if spec.name in self._eps:
            raise ValueError(f"endpoint {spec.name!r} already registered")
        if not spec.name:
            raise ValueError("endpoints need a non-empty name "
                             "(it is the metric label and route key)")
        hpa = spec.hpa if spec.hpa is not None else HPAConfig(
            metric="queue", target=4.0, min_replicas=max(1, spec.min_replicas),
            max_replicas=spec.max_replicas, stabilization_s=5.0,
            scale_down_cooldown_s=5.0)
        # the HPA law floors desired at 1, so its min_replicas floor is 1
        # even for scale-to-zero endpoints — reaching 0 is registry policy
        # (idle teardown), never an autoscaler decision
        hpa = dataclasses.replace(
            hpa, min_replicas=max(1, min(hpa.min_replicas, spec.max_replicas)),
            max_replicas=spec.max_replicas)
        cfg = OrchestratorConfig(
            name=spec.name, min_replicas=spec.min_replicas,
            max_replicas=spec.max_replicas, hpa=hpa,
            scaling=spec.scaling,
            lb_policy=spec.lb_policy,
            cold_start_steps=spec.cold_start_steps,
            idle_ticks_to_zero=spec.idle_ticks_to_zero,
            control_every_steps=spec.control_every_steps,
            transport=self.transport)
        orch = Orchestrator(spec.engine_factory(), cfg,
                            tracer=self.tracer, metrics=self.metrics)
        # autoscaler scale-ups go through the cluster budget (and may
        # trigger a priority eviction) exactly like first-request wakeups
        orch.replica_gate = lambda name=spec.name: self._admit_replica(
            name, self._now)
        self._eps[spec.name] = ep = _Endpoint(spec=spec, orch=orch)
        self._g_state.set(STATE_CODES[self.state(spec.name)],
                          endpoint=spec.name)
        return ep.orch

    def resolve(self, name: str | None) -> Orchestrator | None:
        """The endpoint's orchestrator, or None for an unknown model —
        the completions front-end turns None into an OpenAI-style
        ``invalid_request_error``."""
        if name is None:
            return None
        ep = self._eps.get(name)
        return ep.orch if ep is not None else None

    def names(self) -> list[str]:
        return sorted(self._eps)

    def state(self, name: str) -> str:
        """``ready`` (>=1 warm replica) | ``cold`` (replicas exist but all
        warming) | ``scaled_to_zero`` (no replicas)."""
        ep = self._eps[name]
        if not ep.orch.engines:
            return "scaled_to_zero"
        return "ready" if ep.orch.warm_replicas() > 0 else "cold"

    def describe(self, name: str) -> dict[str, Any]:
        ep = self._eps[name]
        return {"name": name, "state": self.state(name),
                "replicas": len(ep.orch.engines),
                "priority": ep.spec.priority}

    # ----------------------------------------------------------- capacity
    def total_replicas(self) -> int:
        return sum(len(ep.orch.engines) for ep in self._eps.values())

    def _admit_replica(self, name: str, now: float) -> bool:
        """May ``name`` add a replica?  Under budget: yes.  At the budget:
        only by evicting the coolest replica of a strictly lower-priority
        endpoint (emptiest victim endpoint first, so eviction prefers idle
        capacity over live work)."""
        if self.cluster_max_replicas is None or \
                self.total_replicas() < self.cluster_max_replicas:
            return True
        me = self._eps[name].spec.priority
        victims = sorted(
            (ep for ep in self._eps.values()
             if ep.spec.priority < me and ep.orch.engines),
            key=lambda ep: (ep.spec.priority, ep.orch.pending()))
        for vic in victims:
            if vic.orch.evict_coolest(now):
                self._c_evict.inc(victim=vic.spec.name, claimant=name)
                self._g_state.set(STATE_CODES[self.state(vic.spec.name)],
                                  endpoint=vic.spec.name)
                return True
        return False

    # ---------------------------------------------------------- admission
    def submit(self, req: Request, now: float | None = None) -> bool:
        """Route one request to its endpoint by ``req.model``.

        Returns False (with ``req.state = REJECTED``) on a tenant-quota or
        replica-budget rejection; raises KeyError for an unknown model —
        API callers pre-check with :meth:`resolve` and return the
        structured error DTO instead."""
        now = time.perf_counter() if now is None else now
        self._now = now
        ep = self._eps.get(req.model) if req.model is not None else None
        if ep is None:
            raise KeyError(f"unknown model {req.model!r}; "
                           f"available: {self.names()}")
        if req.tenant is None:
            req.tenant = "default"
        # arrival stamps *here*, not at the replica scheduler: a request
        # that waits out a cold start pays that wait in its TTFT
        if req.arrival is None:
            req.arrival = now
        q = self.tenants.get(req.tenant)
        if q is not None and q.max_inflight is not None:
            if len(self._inflight.get(req.tenant, ())) >= q.max_inflight:
                req.state = State.REJECTED
                self._c_tenant_rej.inc(tenant=req.tenant, reason="quota")
                return False
        if not ep.orch.engines:
            # scale-from-zero wakeup: the first request pays for (and
            # measures) the spin-up; it queues behind the warm-up below
            if not self._admit_replica(ep.spec.name, now):
                req.state = State.REJECTED
                self._c_tenant_rej.inc(tenant=req.tenant, reason="capacity")
                return False
            wall = ep.orch.spawn_replica(now)
            self._begin_cold(ep, now, wall)
        ep.orch.submit(req, now)
        if req.state is State.REJECTED:    # replica queue-full
            return False
        self._live[req.rid] = req
        self._inflight.setdefault(req.tenant, set()).add(req.rid)
        self._c_requests.inc(endpoint=ep.spec.name, tenant=req.tenant)
        self._g_state.set(STATE_CODES[self.state(ep.spec.name)],
                          endpoint=ep.spec.name)
        return True

    def _begin_cold(self, ep: _Endpoint, now: float, wall_s: float) -> None:
        ep.cold_rid = next(self._cold_rids)
        ep.cold_begin_step = self._steps
        ep.cold_wall_s = wall_s
        self._c_cold.inc(endpoint=ep.spec.name)
        self.tracer.start_trace(ep.cold_rid, now,
                                replica=f"{ep.spec.name}/ctrl",
                                kind="cold_start", endpoint=ep.spec.name)
        self.tracer.begin(ep.cold_rid, "cold_start", now,
                          replica=f"{ep.spec.name}/ctrl",
                          checkpoint_load_s=wall_s)

    def _finish_cold(self, ep: _Endpoint, now: float) -> None:
        steps = self._steps - ep.cold_begin_step
        self._g_cold_steps.set(steps, endpoint=ep.spec.name)
        self._g_cold_s.set(ep.cold_wall_s, endpoint=ep.spec.name)
        self.tracer.end(ep.cold_rid, "cold_start", now, steps=steps)
        self.tracer.finish(ep.cold_rid, now)
        ep.cold_rid = None

    # ------------------------------------------------------------ stepping
    def step(self, now: float | None = None) -> None:
        """One cluster step: every endpoint steps on the shared clock, then
        the shared transport advances exactly once (each orchestrator
        pumps its own migrations but defers the fabric to us)."""
        now = time.perf_counter() if now is None else now
        self._now = now
        for ep in self._eps.values():
            ep.orch.step(now, pump_transport=False)
        if self.transport is not None:
            self.transport.step()
        self._steps += 1
        for name, ep in self._eps.items():
            if ep.cold_rid is not None and ep.orch.warm_replicas() > 0:
                self._finish_cold(ep, now)
            self._g_state.set(STATE_CODES[self.state(name)], endpoint=name)
        # quota bookkeeping: retire finished/rejected requests
        done = [rid for rid, r in self._live.items() if r.done()]
        for rid in done:
            r = self._live.pop(rid)
            self._inflight.get(r.tenant or "default", set()).discard(rid)

    def drain_events(self) -> list:
        out: list = []
        for ep in self._eps.values():
            out.extend(ep.orch.drain_events())
        return out

    def pending(self) -> int:
        return sum(ep.orch.pending() for ep in self._eps.values())

    def finished(self, name: str | None = None) -> list[Request]:
        """Served requests — one endpoint's, or the whole cluster's."""
        eps = [self._eps[name]] if name is not None else self._eps.values()
        out: list[Request] = []
        for ep in eps:
            out.extend(ep.orch.finished)
            for e in ep.orch.engines:
                out.extend(e.finished)
        return out

    def run(self, max_steps: int = 10_000, now: float | None = None,
            dt: float = 1.0) -> list[Request]:
        """Drive the cluster until drained (wall clock, or a logical clock
        when ``now`` is given)."""
        t = now
        while self.pending() and max_steps > 0:
            self.step(t)
            if t is not None:
                t += dt
            max_steps -= 1
        return self.finished()
