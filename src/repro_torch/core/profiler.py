"""Application profiling (paper §3 'Application profiling').

Emulates the Prometheus/Grafana pipeline: sliding-window metric store with
per-target (layer / stage / replica) latency histograms sampled on the event
clock, percentile queries, right-skew detection, and bottleneck ranking —
the input to load balancing, autoscaling and migration decisions.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict, deque


@dataclasses.dataclass
class Sample:
    t: float
    value: float


class SeriesWindow:
    """Sliding time window of float samples with percentile queries."""

    def __init__(self, window_s: float = 15.0):
        self.window_s = window_s
        self._q: deque[Sample] = deque()

    def observe(self, t: float, value: float) -> None:
        self._q.append(Sample(t, value))
        self._evict(t)

    def _evict(self, now: float) -> None:
        while self._q and self._q[0].t < now - self.window_s:
            self._q.popleft()

    def values(self, now: float | None = None) -> list[float]:
        if now is not None:
            self._evict(now)
        return [s.value for s in self._q]

    def percentile(self, p: float, now: float | None = None) -> float:
        vals = sorted(self.values(now))
        if not vals:
            return 0.0
        i = min(len(vals) - 1, max(0, math.ceil(p / 100.0 * len(vals)) - 1))
        return vals[i]

    def mean(self, now: float | None = None) -> float:
        v = self.values(now)
        return sum(v) / len(v) if v else 0.0

    def max(self, now: float | None = None) -> float:
        v = self.values(now)
        return max(v) if v else 0.0

    def count(self, now: float | None = None) -> int:
        return len(self.values(now))

    def sum(self, now: float | None = None) -> float:
        return sum(self.values(now))

    def effective_span(self, now: float | None = None) -> float:
        """Seconds the window actually covers: ``window_s`` once full, the
        observed span before that — dividing by the full window while it is
        still filling would bias every early rate low (an autoscaler seeing
        half the true arrival rate right when it matters most)."""
        if not self._q:
            return self.window_s
        t = self._q[-1].t if now is None else now
        span = min(self.window_s, t - self._q[0].t)
        # single sample / zero span: fall back to the full window rather
        # than dividing by ~0 and reporting an absurd spike
        return span if span > 0 else self.window_s

    def rate(self, now: float) -> float:
        """Samples per second over the *covered* span (<= window_s)."""
        return self.count(now) / self.effective_span(now)

    def skewness(self, now: float | None = None) -> float:
        """Right-skew indicator: (max - median) / (median - min) proxy, plus
        Fisher skewness when the window has enough mass."""
        v = sorted(self.values(now))
        if len(v) < 3:
            return 0.0
        n = len(v)
        mean = sum(v) / n
        sd = math.sqrt(sum((x - mean) ** 2 for x in v) / n) or 1e-12
        return sum((x - mean) ** 3 for x in v) / n / sd ** 3


class Profiler:
    """Per-target metric store.  Targets are free-form strings
    ('layer/27', 'stage/3/replica/0', 'engine/decode').

    With a :class:`~repro_torch.core.metrics.MetricsRegistry` attached, the
    profiler is a *consumer* of the metrics surface rather than a parallel
    store: every ingest also lands in registry instruments labeled by
    target (``profiler_latency_seconds`` / ``profiler_util`` /
    ``profiler_tokens_total``), so the exposition carries everything the
    control loop sees while the windows keep serving percentile queries."""

    def __init__(self, window_s: float = 15.0, registry=None):
        self.window_s = window_s
        self.registry = registry
        self._m_latency = self._m_util = self._m_tokens = None
        if registry is not None:
            self._m_latency = registry.histogram(
                "profiler_latency_seconds",
                "Observed latency per profiler target", ("target",))
            self._m_util = registry.gauge(
                "profiler_util", "Last observed utilization per target",
                ("target",))
            self._m_tokens = registry.counter(
                "profiler_tokens_total", "Tokens observed per target",
                ("target",))
        self.latency: dict[str, SeriesWindow] = defaultdict(
            lambda: SeriesWindow(window_s))
        self.util: dict[str, SeriesWindow] = defaultdict(
            lambda: SeriesWindow(window_s))
        self.tokens: dict[str, SeriesWindow] = defaultdict(
            lambda: SeriesWindow(window_s))
        self.alltime_max: dict[str, float] = defaultdict(float)
        self.alltime_count: dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------- ingest
    def observe_latency(self, target: str, t: float, seconds: float) -> None:
        self.latency[target].observe(t, seconds)
        self.alltime_max[target] = max(self.alltime_max[target], seconds)
        self.alltime_count[target] += 1
        if self._m_latency is not None:
            self._m_latency.observe(seconds, target=target)

    def observe_util(self, target: str, t: float, frac: float) -> None:
        self.util[target].observe(t, frac)
        if self._m_util is not None:
            self._m_util.set(frac, target=target)

    def observe_tokens(self, target: str, t: float, n: float) -> None:
        """Token-throughput counter (engine prefill/decode tokens per step;
        the autoscaler's 'work arriving' signal alongside queue depth)."""
        self.tokens[target].observe(t, float(n))
        if self._m_tokens is not None:
            self._m_tokens.inc(float(n), target=target)

    # ------------------------------------------------------------- queries
    def p(self, target: str, pct: float, now: float | None = None) -> float:
        return self.latency[target].percentile(pct, now)

    def mean_util(self, target: str, now: float | None = None) -> float:
        return self.util[target].mean(now)

    def token_rate(self, target: str, now: float | None = None) -> float:
        """Tokens per second over the covered span of the sliding window
        (the full ``window_s`` once it has filled)."""
        w = self.tokens[target]
        return w.sum(now) / w.effective_span(now)

    def bottlenecks(self, prefix: str = "", now: float | None = None,
                    metric: str = "max") -> list[tuple[str, float]]:
        """Targets ranked by descending latency metric (paper Fig. 3).
        ``metric`` is one of "max" | "alltime_max" | "p99"."""
        if metric not in ("max", "alltime_max", "p99"):
            raise ValueError(f"unknown bottleneck metric {metric!r}: "
                             "expected 'max', 'alltime_max' or 'p99'")
        rows = []
        for tgt, w in self.latency.items():
            if not tgt.startswith(prefix):
                continue
            v = self.alltime_max[tgt] if metric == "alltime_max" else \
                (w.max(now) if metric == "max" else w.percentile(99, now))
            rows.append((tgt, v))
        return sorted(rows, key=lambda r: -r[1])

    def right_skewed(self, target: str, now: float | None = None,
                     threshold: float = 1.5) -> bool:
        return self.latency[target].skewness(now) > threshold

    def hotspot_ratio(self, prefix: str = "", metric: str = "alltime_max") -> float:
        """max-latency ratio between the worst and best target (the paper's
        '230x Layer 27 vs Layer 30' statistic)."""
        rows = self.bottlenecks(prefix, metric=metric)
        rows = [r for r in rows if r[1] > 0]
        if len(rows) < 2:
            return 1.0
        return rows[0][1] / rows[-1][1]
