"""Proactive, goodput-driven scaling policy (paper §3 'Accurate load
prediction' closed into the autoscaler loop).

The reactive HPA law scales on the *current* value of one raw metric.
This policy instead plans replica counts from three signals sampled on
the logical step clock:

1. **Forecast load** — per-endpoint arrival work (prompt + decode-budget
   tokens per step) feeds a :mod:`repro_torch.core.predictor` forecaster, and
   the plan is made at the forecast horizon, not at "now".  The horizon
   defaults to the replica warm-up lag (``cold_start_steps``) plus one
   control period: a scale-up fired on the forecast is *schedulable* the
   moment the predicted load actually lands, hiding the cold start.
2. **Capacity model** — tokens/step one warm replica sustains, learned
   online from the served-token telemetry the profiler window already
   carries (an EWMA updated only while the endpoint is backlogged, so
   idle ticks never erode it).  ``desired = ceil(demand / capacity)``
   replaces the HPA's relative ``ceil(current * metric / target)`` —
   the policy can jump straight to the replica count the spike needs
   instead of ratcheting up one control period at a time.
3. **Goodput objective** — the fraction of SLO-carrying requests meeting
   their TTFT/TPOT deadlines, with misses decomposed by
   :func:`repro_torch.core.tracing.attribute_slo_misses`.  Queue-dominated
   misses are a capacity shortfall: they bias the plan up beyond the
   forecast.  Scale-down is only permitted while windowed goodput holds
   at/above ``goodput_floor`` with no recent queue-dominated miss — the
   policy optimizes % of requests served within SLO, not raw utilization.

The policy plugs into :class:`repro_torch.core.autoscaler.Autoscaler` as an
alternative desired-replica source; the HPA *behaviors* (tolerance-free
clamping, scale-down stabilization window, per-direction cooldowns) stay
shared, so proactive and reactive differ only in how "desired" is
computed, never in flap protection.

Host-side Python only (no torch): importable by the control plane and the
benchmarks alike.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.core.predictor import make_predictor


@dataclasses.dataclass
class ScalingSignals:
    """One control tick's view of an endpoint, on the logical step clock.

    Token units throughout: a request's *work* is
    ``len(prompt) + sampling.max_new_tokens`` — what admission will cost
    end to end, the same unit the capacity model learns in."""
    queue_depth: int = 0        # requests waiting cluster-wide
    queue_tokens: int = 0       # work tokens those waiting requests carry
    served_tokens: int = 0      # tokens produced since the previous tick
    steps: int = 1              # logical steps since the previous tick
    warm_replicas: int = 0      # replicas past their cold start
    total_replicas: int = 0     # including still-warming ones


@dataclasses.dataclass
class ProactiveConfig:
    """Knobs of the proactive goodput policy (defaults favor hiding a
    cold start over hugging the utilization optimum)."""
    predictor: str = "holt"             # "ewma" | "holt" | "ar"
    predictor_kw: dict = dataclasses.field(default_factory=dict)
    # forecast horizon in logical steps.  None derives the warm-up-aware
    # default: cold_start_steps + one control period — scale now, be warm
    # when the forecast load lands.
    horizon_steps: int | None = None
    # capacity model: learned tokens/step per warm replica
    capacity_floor: float = 4.0         # never plan below this throughput
    capacity_decay: float = 0.25        # EWMA weight of a fresh observation
    target_util: float = 0.8            # plan at this fraction of capacity
    # token backlog is amortized over this many steps on top of forecast
    # arrivals (a small number drains spikes aggressively)
    drain_steps: float = 8.0
    # goodput objective
    goodput_window: int = 64            # finished SLO-carrying requests
    goodput_floor: float = 0.97         # scale-down allowed at/above this
    queue_miss_boost: int = 1           # extra replicas while queue misses persist
    miss_patience: int = 2              # control ticks a miss bias survives


class ProactiveScalingPolicy:
    """Desired-replica source for :class:`~repro_torch.core.autoscaler.Autoscaler`.

    The orchestrator feeds it arrivals (:meth:`note_arrival`) and request
    outcomes (:meth:`observe_outcomes`) and hands it a
    :class:`ScalingSignals` snapshot each control tick; the autoscaler
    asks :meth:`desired_replicas` and applies the shared HPA behaviors to
    the answer."""

    def __init__(self, cfg: ProactiveConfig | None = None, *,
                 cold_start_steps: int = 0, control_every_steps: int = 1,
                 name: str = "default"):
        self.cfg = cfg if cfg is not None else ProactiveConfig()
        self.name = name
        self.control_every = max(1, control_every_steps)
        self.horizon_steps = (self.cfg.horizon_steps
                              if self.cfg.horizon_steps is not None
                              else cold_start_steps + self.control_every)
        kw = dict(self.cfg.predictor_kw)
        if self.cfg.predictor in ("holt", "ar"):
            # observations arrive once per control tick; dt converts the
            # per-tick trend/steps into the per-step horizon contract
            kw.setdefault("dt", float(self.control_every))
        self.predictor = make_predictor(self.cfg.predictor, **kw)
        self.forecast = 0.0                 # last horizon forecast (tokens/step)
        self.forecast_error = 0.0           # |forecast - realized| at horizon
        self.capacity: float | None = None  # learned tokens/step per replica
        self._arrived_tokens = 0.0
        self._pending_forecasts: deque[tuple[float, float]] = deque()
        self._outcomes: deque[bool] = deque(maxlen=self.cfg.goodput_window)
        self._miss_bias_ticks = 0
        self._m_forecast = None

    # -------------------------------------------------------------- metrics
    def attach_metrics(self, registry, endpoint: str = "default") -> None:
        self._ep = endpoint or "default"
        self._m_forecast = registry.gauge(
            "autoscaler_forecast",
            "Forecast load at the scaling horizon (work tokens/step)",
            ("endpoint",))
        self._m_fc_err = registry.gauge(
            "autoscaler_forecast_error",
            "Abs error of the forecast made one horizon ago vs realized load",
            ("endpoint",))
        self._m_lead = registry.gauge(
            "autoscaler_lead_steps",
            "Forecast horizon in logical steps (planned scale-up lead)",
            ("endpoint",))
        self._m_goodput = registry.gauge(
            "autoscaler_goodput",
            "Windowed fraction of SLO-carrying requests meeting their SLOs",
            ("endpoint",))
        self._m_capacity = registry.gauge(
            "autoscaler_capacity_tokens_per_step",
            "Learned per-replica serving capacity (work tokens/step)",
            ("endpoint",))
        self._m_lead.set(self.horizon_steps, endpoint=self._ep)

    # --------------------------------------------------------------- inputs
    def note_arrival(self, now: float, work_tokens: float) -> None:
        """One submitted request's work (prompt + decode budget tokens)."""
        self._arrived_tokens += float(work_tokens)

    def observe_outcomes(self, finished, miss_rows) -> None:
        """Score requests that finished since the last tick against their
        SLOs, and ingest their :func:`attribute_slo_misses` rows — a
        queue-dominated miss arms the scale-up bias for
        ``miss_patience`` control ticks."""
        for r in finished:
            if r.slo_ttft is not None or r.slo_tpot is not None:
                self._outcomes.append(bool(r.slo_met()))
        if any(row.get("dominant") == "queue_wait" for row in miss_rows):
            self._miss_bias_ticks = self.cfg.miss_patience

    def goodput(self) -> float:
        """Windowed goodput; an empty window reads as healthy (1.0)."""
        if not self._outcomes:
            return 1.0
        return sum(self._outcomes) / len(self._outcomes)

    # ---------------------------------------------------------- control tick
    def on_control_tick(self, t: float, sig: ScalingSignals) -> None:
        """Sample the arrival window, update the capacity model, advance
        the forecaster, and refresh the gauges.  Called exactly once per
        control tick, before :meth:`desired_replicas`."""
        steps = max(sig.steps, 1)
        rate = self._arrived_tokens / steps
        self._arrived_tokens = 0.0
        # capacity: tokens/step per warm replica, learned only while there
        # is a backlog (an idle replica serves 0 tokens/step but can do far
        # better — averaging idle ticks in would collapse the model)
        if sig.queue_depth > 0 and sig.warm_replicas > 0 \
                and sig.served_tokens > 0:
            obs = sig.served_tokens / steps / sig.warm_replicas
            d = self.cfg.capacity_decay
            self.capacity = obs if self.capacity is None else \
                (1 - d) * self.capacity + d * obs
        # realized forecast error: compare the forecast whose target time
        # has now arrived against the rate just observed
        while self._pending_forecasts and self._pending_forecasts[0][0] <= t:
            _, fc = self._pending_forecasts.popleft()
            self.forecast_error = abs(fc - rate)
        self.predictor.observe(t, rate)
        self.forecast = self.predictor.forecast(float(self.horizon_steps))
        self._pending_forecasts.append((t + self.horizon_steps, self.forecast))
        if self._m_forecast is not None:
            self._m_forecast.set(self.forecast, endpoint=self._ep)
            self._m_fc_err.set(self.forecast_error, endpoint=self._ep)
            self._m_goodput.set(self.goodput(), endpoint=self._ep)
            self._m_capacity.set(self.capacity or 0.0, endpoint=self._ep)

    # --------------------------------------------------------------- output
    def effective_capacity(self) -> float:
        cap = self.capacity if self.capacity is not None \
            else self.cfg.capacity_floor
        return max(cap, self.cfg.capacity_floor) * self.cfg.target_util

    def desired_replicas(self, t: float, current: int,
                         sig: ScalingSignals) -> int:
        """Raw desired count (the autoscaler clamps and stabilizes it):
        forecast arrivals plus amortized backlog over learned capacity,
        biased up while queue-dominated SLO misses persist, and held at
        ``current`` when goodput says scaling down would be reckless."""
        cfg = self.cfg
        demand = self.forecast + sig.queue_tokens / max(cfg.drain_steps, 1.0)
        want = math.ceil(demand / self.effective_capacity()) if demand > 0 else 1
        want = max(want, 1)     # the HPA law floors at 1; scale-to-zero is
        #                         registry policy, never a scaler decision
        biased = self._miss_bias_ticks > 0
        if biased:
            # queue-dominated misses = the plan was short; add headroom
            # beyond whichever of forecast/current is larger
            want = max(want, current + cfg.queue_miss_boost)
            # the bias is consumed here (once per control tick — the
            # autoscaler calls desired_replicas exactly once per tick), so
            # it survives exactly miss_patience plans
            self._miss_bias_ticks -= 1
        if want < current and not (self.goodput() >= cfg.goodput_floor
                                   and not biased):
            # goodput guard: only surrender replicas while the SLOs hold
            want = current
        return want
