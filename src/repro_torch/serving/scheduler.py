"""Admission control + queueing for continuous batching.

Policies:
* fcfs      — arrival order
* sjf       — shortest predicted job first (prompt length proxy)
* slo       — earliest-ttft-deadline first
* wfq       — weighted-fair across tenants (``Request.tenant``): each
              admission charges the tenant's virtual time by the request's
              token cost over its weight, and the tenant with the lowest
              virtual time always owns the next pick — under saturation,
              tenants converge to token shares proportional to their
              ``tenant_weights`` while staying FIFO within a tenant.

Admission per engine step follows Orca-style continuous batching: every
iteration, free rows are refilled from the queue (up to ``max_prefill_per
_step`` to bound prefill head-of-line blocking of running decodes).

Per-step prefill *work* is additionally bounded by ``prefill_token_budget``:
the engine passes the budget left after continuing any in-flight chunked
prefills, and :meth:`Scheduler.next_batch` admits requests in policy order
until the budget is spent (the first pick always goes through so a single
long prompt can never be starved by its own cost).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable

from repro_torch.serving.request import Request, State


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "fcfs"            # fcfs | sjf | slo | wfq
    # "wfq": tenant -> weight (unlisted tenants weigh 1.0).  A tenant with
    # weight 3 earns ~3x the admitted tokens of a weight-1 tenant while
    # both are backlogged.
    tenant_weights: dict[str, float] | None = None
    max_queue: int = 10_000
    max_prefill_per_step: int = 4
    prefill_token_budget: int | None = None  # per-step prefilled-token cap
    admission_timeout: float | None = None   # reject if queued longer (s)
    # which token count the admission budget charges when the engine's cost
    # callable reports (padded, true) separately: "padded" = compute tokens
    # including bucket/chunk padding (what a step actually costs), "true" =
    # prompt tokens only (what the request actually needs)
    budget_counts: str = "padded"
    # SLO guard: when a running decode row's observed TPOT is at deadline
    # risk (>= slo_tpot * margin), the engine withholds *new* prefill
    # admissions, and after ``patience`` consecutive risky steps preempts
    # the freshest mid-prefill row back to the queue head — a deadline-risk
    # decode displaces a fresh prefill instead of queueing behind it
    slo_guard: bool = False
    slo_guard_margin: float = 1.0
    slo_guard_patience: int = 2


def deadline_risk(running: Iterable[Request], margin: float = 1.0) -> list[Request]:
    """Decode-phase requests whose observed TPOT is at (or past) their
    ``slo_tpot`` deadline, scaled by ``margin`` (< 1.0 flags risk *before*
    the SLO is violated).  Requests without a TPOT SLO, or without two
    tokens yet, carry no measurable risk."""
    out = []
    for r in running:
        if r.slo_tpot is None:
            continue
        tpot = r.tpot
        if tpot is not None and tpot >= r.slo_tpot * margin:
            out.append(r)
    return out


class Scheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        assert cfg.budget_counts in ("padded", "true"), cfg.budget_counts
        self.cfg = cfg
        self.queue: deque[Request] = deque()
        self.rejected = 0
        # "wfq" state: per-tenant virtual time (service over weight).  A
        # tenant first seen mid-run starts at the *minimum* live virtual
        # time, not zero — an idle tenant must not bank credit it can later
        # spend starving everyone else.
        self._vtime: dict[str, float] = {}
        # observability hook: called as on_reject(req, now, reason) for
        # every rejection this scheduler decides ("queue-full" at submit,
        # "timeout" at admission) — the engine binds it so rejected
        # requests' traces close instead of orphaning their queue_wait span
        self.on_reject: Callable[[Request, float, str], None] | None = None

    def _reject(self, req: Request, now: float, reason: str) -> None:
        req.state = State.REJECTED
        self.rejected += 1
        if self.on_reject is not None:
            self.on_reject(req, now, reason)

    def submit(self, req: Request, now: float) -> bool:
        if len(self.queue) >= self.cfg.max_queue:
            self._reject(req, now, "queue-full")
            return False
        # ``is None`` — an explicit arrival == 0.0 is a legitimate event-clock
        # time (simulations start at t=0) and must not be overwritten.
        if req.arrival is None:
            req.arrival = now
        self.queue.append(req)
        return True

    def _key(self, r: Request, now: float):
        if self.cfg.policy == "sjf":
            return len(r.prompt)
        if self.cfg.policy == "slo":
            dl = r.arrival + (r.slo_ttft if r.slo_ttft is not None else 1e9)
            return dl
        return r.arrival

    def next_batch(self, free_slots: int, now: float,
                   budget: int | None = None,
                   cost: Callable[[Request], int] | None = None) -> list[Request]:
        """Pop up to min(free_slots, max_prefill_per_step) requests.

        ``budget`` caps the summed per-request prefill cost (tokens the engine
        will prefill for the request *this step* — bucketed length for short
        prompts, one chunk for long ones); ``cost`` maps a request to that
        number (default: prompt length), either a plain int or a
        ``(padded, true)`` pair charged per ``cfg.budget_counts`` — padded
        counts the compute the step really runs (bucket/chunk padding
        included, prefix-cached tokens excluded), true counts prompt tokens.
        The first pick is always admitted even if it alone exceeds the
        budget, so admission always progresses.
        """
        # expire
        if self.cfg.admission_timeout is not None:
            kept = deque()
            for r in self.queue:
                if now - r.arrival > self.cfg.admission_timeout:
                    self._reject(r, now, "timeout")
                else:
                    kept.append(r)
            self.queue = kept
        n = min(free_slots, self.cfg.max_prefill_per_step, len(self.queue))
        if n <= 0:
            return []
        if self.cfg.policy == "wfq":
            picked = self._wfq_pick(n, budget, cost)
            picked_set = {id(r) for r in picked}
            self.queue = deque(r for r in self.queue if id(r) not in picked_set)
            return picked
        ordered = sorted(self.queue, key=lambda r: self._key(r, now))
        if budget is None:
            picked = ordered[:n]
        else:
            picked, spent = [], 0
            idx = 1 if self.cfg.budget_counts == "true" else 0
            for r in ordered[:n]:
                c = cost(r) if cost is not None else len(r.prompt)
                if isinstance(c, tuple):
                    c = c[idx]
                if picked and spent + c > budget:
                    break
                picked.append(r)
                spent += c
        picked_set = {id(r) for r in picked}
        self.queue = deque(r for r in self.queue if id(r) not in picked_set)
        return picked

    def _wfq_pick(self, n: int,
                  budget: int | None,
                  cost: Callable[[Request], int] | None) -> list[Request]:
        """Weighted-fair selection: the backlogged tenant with the lowest
        virtual time owns each pick (FIFO within the tenant), and every
        admission advances that tenant's virtual time by the request's full
        token cost (prompt + max_new_tokens) over its weight — so under
        saturation admitted tokens converge to weight-proportional shares."""
        fifos: dict[str, deque[Request]] = {}
        for r in self.queue:
            fifos.setdefault(r.tenant or "default", deque()).append(r)
        # a tenant first seen (or returning from idle) joins at the minimum
        # live virtual time — no banked credit for having been absent
        known = [self._vtime[t] for t in fifos if t in self._vtime]
        base = min(known) if known else 0.0
        for t in fifos:
            self._vtime.setdefault(t, base)
        weights = self.cfg.tenant_weights or {}
        idx = 1 if self.cfg.budget_counts == "true" else 0
        picked: list[Request] = []
        spent = 0
        while len(picked) < n and fifos:
            t = min(fifos, key=lambda k: (self._vtime[k], fifos[k][0].arrival))
            r = fifos[t][0]
            if budget is not None:
                c = cost(r) if cost is not None else len(r.prompt)
                if isinstance(c, tuple):
                    c = c[idx]
                if picked and spent + c > budget:
                    break
                spent += c
            w = float(weights.get(t, 1.0))
            self._vtime[t] += (len(r.prompt) + r.sampling.max_new_tokens) / max(w, 1e-9)
            picked.append(r)
            fifos[t].popleft()
            if not fifos[t]:
                del fifos[t]
        return picked

    def depth(self) -> int:
        return len(self.queue)
