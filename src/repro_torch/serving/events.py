"""Typed per-request events emitted by the serving engine.

The engine's ``step()`` no longer only returns aggregate :class:`StepStats`
— every request-visible transition is emitted as an event, so front-ends
(``serving/api.py``), the orchestrator, and benches observe per-request
truths (TTFT = the ``FirstTokenEvent`` timestamp, TPOT = gaps between
``TokenEvent`` timestamps) instead of per-step proxies.

Ordering contract:

* ``TokenEvent.index`` is the token's position in ``Request.output``.  A
  consumer tracking a per-rid cursor sees indices ``0, 1, 2, ...`` with no
  gaps.  After a migration *rollback* (the request restarted from scratch),
  already-emitted indices may be re-emitted by the re-serving replica —
  :class:`StreamDemux` in ``serving/api.py`` drops those duplicates, so a
  downstream stream is append-only with no duplicated or dropped tokens.
* ``FirstTokenEvent`` is a ``TokenEvent`` (``index == 0``): stream
  consumers handle both uniformly, latency consumers can key on the
  subclass.
* ``FinishEvent`` follows the request's last ``TokenEvent`` in the same
  step; ``reason`` mirrors the OpenAI finish reasons (``"stop"`` — stop
  token sampled, ``"length"`` — max_new_tokens or the cache row filled).
* ``PreemptEvent`` marks a request leaving its row *without* finishing:
  ``"migrate"`` (live handoff to another replica — the stream resumes from
  the destination at the next index), ``"requeued"`` (migration rollback
  failed, restarted from the queue — earlier indices will be re-emitted),
  ``"slo-decode-pressure"`` (a deadline-risk decode row displaced this
  fresh prefill; it re-enters at the queue head).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineEvent:
    t: float                    # engine step clock (wall or logical)
    rid: int


@dataclasses.dataclass(frozen=True)
class TokenEvent(EngineEvent):
    token: int
    index: int                  # position in Request.output


@dataclasses.dataclass(frozen=True)
class FirstTokenEvent(TokenEvent):
    """The request's first output token (prefill complete): its timestamp
    against ``Request.arrival`` is the per-request TTFT."""


@dataclasses.dataclass(frozen=True)
class FinishEvent(EngineEvent):
    reason: str                 # "stop" | "length"
    n_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class PreemptEvent(EngineEvent):
    reason: str                 # "migrate" | "requeued" | "slo-decode-pressure"
