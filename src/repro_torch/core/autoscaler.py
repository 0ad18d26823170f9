"""Cloud-native autoscaling (paper §3 'Autoscaling').

Implements the Kubernetes HPA control law exactly:

    desired = ceil(current * metric / target)

with the HPA behaviors that matter in practice: tolerance band, min/max
replicas, scale-down stabilization window (use the *max* desired over the
window to avoid flapping), per-direction cooldowns, and pod cold-start
latency (handled by the cluster layer: a new replica becomes schedulable
only after its model shard loads).

Three modes:
* reactive  — metric is the current windowed observation (paper setting)
* proactive — metric is a predictor forecast at the cold-start horizon
* policy    — a pluggable desired-replica source (e.g.
  :class:`~repro_torch.core.scaling_policy.ProactiveScalingPolicy`, the
  goodput-driven planner) computes the raw desired count from
  :class:`~repro_torch.core.scaling_policy.ScalingSignals`; the HPA behaviors
  (clamping, stabilization window, cooldowns) still apply to its output,
  so flap protection is identical across modes.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class HPAConfig:
    metric: str = "latency"         # 'latency' | 'util' | 'queue' | 'kv_util'
    target: float = 1.0             # target metric value (e.g. seconds / util frac)
    min_replicas: int = 1
    max_replicas: int = 8
    tolerance: float = 0.1          # +-10% dead band (K8s default)
    stabilization_s: float = 15.0   # scale-down window (paper: 15s metric window)
    scale_up_cooldown_s: float = 0.0
    scale_down_cooldown_s: float = 15.0
    proactive: bool = False
    horizon_s: float = 10.0         # forecast horizon ~ cold-start time


class Autoscaler:
    def __init__(self, cfg: HPAConfig, predictor=None, policy=None):
        self.cfg = cfg
        self.predictor = predictor
        # pluggable desired-replica source (duck type: on_control_tick(t,
        # signals), desired_replicas(t, current, signals), .forecast).
        # Engaged only when evaluate() receives a signals snapshot.
        self.policy = policy
        self._desired_hist: list[tuple[float, int]] = []
        self._last_up = -1e30
        self._last_down = -1e30
        self.decisions: list[tuple[float, int, int, float]] = []  # (t, cur, new, metric)
        self._m_events = None

    def attach_metrics(self, registry, endpoint: str = "default") -> None:
        """Bind autoscaler instruments onto a cluster metrics registry.

        ``endpoint`` labels every sample so several endpoints' autoscalers
        can share one registry without clobbering each other (label hygiene:
        callers pass a non-empty name; the bare orchestrator passes
        "default")."""
        self._ep = endpoint or "default"
        self._m_events = registry.counter(
            "autoscaler_scale_events_total", "Scale decisions, by direction",
            ("direction", "endpoint"))
        self._m_metric = registry.gauge(
            "autoscaler_metric", "Last metric value the control law saw",
            ("endpoint",))

    def _raw_desired(self, current: int, metric: float) -> int:
        c = self.cfg
        if c.target <= 0:
            return current
        ratio = metric / c.target
        if abs(ratio - 1.0) <= c.tolerance:
            return current
        return max(1, math.ceil(current * ratio))

    def evaluate(self, t: float, current: int, metric: float,
                 signals=None) -> int:
        """Returns the new replica count (== current when no action).

        With a policy attached and a ``signals`` snapshot provided, the
        raw desired count comes from the policy instead of the HPA ratio
        law; everything after (clamp, stabilization, cooldowns, decision
        log, metrics) is shared."""
        c = self.cfg
        if self.policy is not None and signals is not None:
            self.policy.on_control_tick(t, signals)
            desired = self.policy.desired_replicas(t, current, signals)
            metric = self.policy.forecast    # what the decision log records
        else:
            if c.proactive and self.predictor is not None:
                self.predictor.observe(t, metric)
                metric = self.predictor.forecast(c.horizon_s)
            desired = self._raw_desired(current, metric)
        if self._m_events is not None:
            self._m_metric.set(metric, endpoint=self._ep)
        desired = min(max(desired, c.min_replicas), c.max_replicas)

        self._desired_hist.append((t, desired))
        self._desired_hist = [(tt, d) for tt, d in self._desired_hist
                              if tt >= t - c.stabilization_s]

        if desired > current:
            if t - self._last_up < c.scale_up_cooldown_s:
                return current
            self._last_up = t
            self.decisions.append((t, current, desired, metric))
            if self._m_events is not None:
                self._m_events.inc(direction="up", endpoint=self._ep)
            return desired
        if desired < current:
            # scale-down stabilization: act on the max desired in the window;
            # cooldown counts from the last scale event in EITHER direction
            # (K8s semantics: a fresh scale-up blocks immediate down-flap)
            stab = max(d for _, d in self._desired_hist)
            stab = min(max(stab, c.min_replicas), c.max_replicas)
            last_event = max(self._last_down, self._last_up)
            if stab >= current or t - last_event < c.scale_down_cooldown_s:
                return current
            self._last_down = t
            self.decisions.append((t, current, stab, metric))
            if self._m_events is not None:
                self._m_events.inc(direction="down", endpoint=self._ep)
            return stab
        return current
