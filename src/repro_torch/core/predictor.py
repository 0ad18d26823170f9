"""Load prediction (paper §3 'Accurate load prediction').

Time-series forecasters driving *proactive* autoscaling: EWMA, Holt-Winters
(double-exponential: level + trend), and a windowed autoregressive model fit
by least squares.  All share observe(t, v) / forecast(horizon_s).
"""
from __future__ import annotations

import math

import numpy as np


class EWMA:
    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.level: float | None = None

    def observe(self, t: float, v: float) -> None:
        self.level = v if self.level is None else \
            self.alpha * v + (1 - self.alpha) * self.level

    def forecast(self, horizon_s: float = 0.0) -> float:
        return max(0.0, self.level or 0.0)


class HoltWinters:
    """Double exponential smoothing (level + trend); horizon-aware."""

    def __init__(self, alpha: float = 0.4, beta: float = 0.2, dt: float = 1.0):
        self.alpha, self.beta, self.dt = alpha, beta, dt
        self.level: float | None = None
        self.trend = 0.0

    def observe(self, t: float, v: float) -> None:
        if self.level is None:
            self.level = v
            return
        prev = self.level
        self.level = self.alpha * v + (1 - self.alpha) * (self.level + self.trend)
        self.trend = self.beta * (self.level - prev) + (1 - self.beta) * self.trend

    def forecast(self, horizon_s: float = 0.0) -> float:
        if self.level is None:
            return 0.0
        steps = horizon_s / self.dt
        return max(0.0, self.level + steps * self.trend)


class WindowedAR:
    """AR(p) over the last ``window`` samples, refit on demand.

    ``dt`` is the seconds between consecutive observations: it converts
    the shared ``forecast(horizon_s)`` contract into the number of
    one-step iterations the fitted model rolls forward."""

    def __init__(self, order: int = 4, window: int = 64, dt: float = 1.0):
        self.order, self.window, self.dt = order, window, dt
        self.hist: list[float] = []

    def observe(self, t: float, v: float) -> None:
        self.hist.append(v)
        if len(self.hist) > self.window:
            self.hist.pop(0)

    def _fit(self) -> np.ndarray | None:
        h = np.asarray(self.hist, np.float64)
        p = self.order
        if len(h) < p + 2:
            return None
        X = np.stack([h[i:len(h) - p + i] for i in range(p)], axis=1)
        y = h[p:]
        X = np.concatenate([X, np.ones((len(y), 1))], axis=1)
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        return coef

    def forecast(self, horizon_s: float = 0.0, steps: int | None = None) -> float:
        """Roll the fitted AR(p) forward ``ceil(horizon_s / dt)`` steps (at
        least one).  ``steps`` overrides the conversion for callers that
        already think in model steps."""
        if steps is None:
            steps = math.ceil(horizon_s / self.dt) if horizon_s > 0 else 1
        coef = self._fit()
        if coef is None:
            return max(0.0, self.hist[-1]) if self.hist else 0.0
        h = list(self.hist)
        for _ in range(max(1, steps)):
            x = np.asarray(h[-self.order:] + [1.0])
            # iterated AR forecasts can diverge when the fitted poles sit
            # outside the unit circle; keep every iterate finite so a long
            # horizon degrades to a clamped number, never inf/nan
            nxt = float(x @ coef)
            if not math.isfinite(nxt):
                return max(0.0, self.hist[-1])
            h.append(min(max(nxt, -1e12), 1e12))
        return max(0.0, h[-1])


def make_predictor(kind: str, **kw):
    return {"ewma": EWMA, "holt": HoltWinters, "ar": WindowedAR}[kind](**kw)
