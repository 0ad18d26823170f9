"""OpenAI-style completions front-end over the event-driven engine.

Request/response DTOs in the shape of the ``/v1/completions`` API, a sync
path, and a streaming generator that yields one SSE-style chunk per emitted
token.  The backend is anything that speaks the serving step protocol —
the in-process :class:`~repro_torch.serving.engine.InferenceEngine`, the
cluster :class:`~repro_torch.core.orchestrator.Orchestrator`, or the
:class:`~repro_torch.core.disaggregation.DisaggregatedServer`:

    submit(request, now)      admit one request
    step(now)                 one serving iteration
    drain_events() / StepStats.events    the typed per-token event stream
    pending()                 anything left to serve

Both paths are fed from the *event stream*, not from ``Request.output`` —
the response is literally the assembled stream, so sync and streaming are
equivalent by construction (and asserted so).  :class:`StreamDemux` keeps
per-request streams append-only across migrations: a successful handoff
continues at the next token index from the new replica; a rollback-requeue
re-emits earlier indices, which the demux drops.

This repo serves token ids (there is no tokenizer): ``prompt`` is a list
of ids and chunks carry ``tokens`` instead of ``text``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from collections import deque
from typing import Any, Iterator

from repro_torch.serving.events import (EngineEvent, FinishEvent, PreemptEvent,
                                  TokenEvent)
from repro_torch.serving.request import Request, SamplingParams, State


def _trace_hex(rid: int) -> str:
    """Trace id for a rid (function-level import: repro_torch.core imports this
    module, so a top-level import of repro_torch.core.tracing would be circular).
    Response/chunk ids embed it so callers can join API output to traces."""
    from repro_torch.core.tracing import trace_id_hex
    return trace_id_hex(rid)

# ------------------------------------------------------------------- DTOs


@dataclasses.dataclass
class CompletionRequest:
    """The ``/v1/completions`` request body (token-id variant).

    ``model`` is *required* — it is the route key: against an
    :class:`~repro_torch.core.endpoints.EndpointRegistry` backend it selects the
    endpoint (an unknown name returns a :class:`CompletionError`, never a
    bare exception); against a single-model backend it must match the
    API's configured model name."""
    prompt: list[int]
    model: str
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: int | None = None          # stop token id
    stream: bool = False
    # per-request SLOs (seconds, or steps under a logical clock): drive the
    # scheduler's deadline priority / the engine's preemption guard
    slo_ttft: float | None = None
    slo_tpot: float | None = None
    # multi-tenancy: quota + weighted-fair scheduling key (None lands in
    # the "default" tenant at admission)
    tenant: str | None = None

    def to_request(self, rid: int) -> Request:
        return Request(
            rid=rid, prompt=list(self.prompt),
            sampling=SamplingParams(temperature=self.temperature,
                                    top_k=self.top_k, top_p=self.top_p,
                                    max_new_tokens=self.max_tokens,
                                    stop_token=self.stop),
            slo_ttft=self.slo_ttft, slo_tpot=self.slo_tpot,
            model=self.model, tenant=self.tenant)


@dataclasses.dataclass
class CompletionChoice:
    index: int
    tokens: list[int]
    finish_reason: str | None        # "stop" | "length" | "rejected" | None


@dataclasses.dataclass
class CompletionUsage:
    prompt_tokens: int
    completion_tokens: int
    total_tokens: int


@dataclasses.dataclass
class CompletionResponse:
    id: str
    created: float
    model: str
    choices: list[CompletionChoice]
    usage: CompletionUsage
    object: str = "text_completion"
    # per-request serving truths the OpenAI shape has no slot for — under
    # an ``x_`` extension key so the core shape stays recognisable
    x_ttft: float | None = None
    x_tpot: float | None = None
    x_migrations: int = 0
    x_trace_id: str | None = None    # join key into --trace-out output

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CompletionChunk:
    """One streamed SSE frame: a single token (or the bare finish frame)."""
    id: str
    created: float
    model: str
    choices: list[dict[str, Any]]
    object: str = "text_completion.chunk"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_sse(self) -> str:
        return f"data: {json.dumps(self.to_dict())}\n\n"


SSE_DONE = "data: [DONE]\n\n"


@dataclasses.dataclass
class CompletionError:
    """OpenAI-style structured error body (``{"error": {...}}``).

    Returned (sync) or yielded as the only frame (streaming) instead of
    raising, so API consumers handle bad requests like an HTTP 4xx body
    rather than a crashed connection."""
    message: str
    type: str = "invalid_request_error"
    param: str | None = None
    code: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {"error": {"message": self.message, "type": self.type,
                          "param": self.param, "code": self.code}}

    def to_sse(self) -> str:
        return f"data: {json.dumps(self.to_dict())}\n\n"


# ---------------------------------------------------------------- models API
@dataclasses.dataclass
class ModelInfo:
    """One ``/v1/models`` entry, extended with the serving truths the
    registry knows: lifecycle state, replica count, priority class."""
    id: str
    state: str                       # "ready" | "cold" | "scaled_to_zero"
    replicas: int
    priority: int
    object: str = "model"
    owned_by: str = "repro"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModelList:
    data: list[ModelInfo]
    object: str = "list"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class ModelsAPI:
    """``/v1/models``-shaped read surface over an
    :class:`~repro_torch.core.endpoints.EndpointRegistry`."""

    def __init__(self, registry):
        self.registry = registry

    def _info(self, name: str) -> ModelInfo:
        d = self.registry.describe(name)
        return ModelInfo(id=d["name"], state=d["state"],
                         replicas=d["replicas"], priority=d["priority"])

    def list(self) -> ModelList:
        return ModelList(data=[self._info(n) for n in self.registry.names()])

    def retrieve(self, name: str) -> ModelInfo | CompletionError:
        if self.registry.resolve(name) is None:
            return CompletionError(
                message=f"model {name!r} not found; "
                        f"available: {self.registry.names()}",
                param="model", code="model_not_found")
        return self._info(name)


# ------------------------------------------------------------ demux/cursor
class StreamDemux:
    """Per-rid ordering/dedup over a merged engine event stream.

    ``feed`` returns the token events that advance each request's stream:
    index == cursor passes and advances it; index < cursor is a re-emission
    after a migration rollback and is dropped (the stream already carried
    it); index > cursor means the engine dropped a token — an invariant
    violation, raised loudly."""

    def __init__(self):
        self.cursor: dict[int, int] = {}

    def feed(self, events: list[EngineEvent]) -> list[TokenEvent]:
        out = []
        for ev in events:
            if not isinstance(ev, TokenEvent):
                continue
            c = self.cursor.get(ev.rid, 0)
            if ev.index == c:
                self.cursor[ev.rid] = c + 1
                out.append(ev)
            elif ev.index > c:
                raise RuntimeError(
                    f"stream gap for rid {ev.rid}: got index {ev.index}, "
                    f"cursor {c} — a token was dropped")
        return out

    def forget(self, rid: int) -> None:
        self.cursor.pop(rid, None)


# ---------------------------------------------------------------- frontend
class CompletionsAPI:
    """Completions front-end over one serving backend.

    ``now``/``dt``: pass ``now`` to run on a logical clock (each backend
    step advances it by ``dt``); leave it ``None`` for wall time.  Multiple
    interleaved ``stream()`` generators share the backend fairly — each
    pump fans events out to every open stream's buffer.

    Routing: a backend exposing ``resolve(name)`` (the
    :class:`~repro_torch.core.endpoints.EndpointRegistry`) serves every model it
    knows — ``CompletionRequest.model`` picks the endpoint and an unknown
    name comes back as a :class:`CompletionError`.  Any other backend
    serves exactly one model (``model=``) and mismatches error the same
    way."""

    def __init__(self, backend, model: str = "repro-lm"):
        self.backend = backend
        self.model = model
        self._rids = itertools.count()
        self._buffers: dict[int, deque[EngineEvent]] = {}

    def _route_error(self, creq: CompletionRequest) -> CompletionError | None:
        """Structured unknown-model error, or None when routable."""
        resolve = getattr(self.backend, "resolve", None)
        if resolve is not None:
            if resolve(creq.model) is None:
                return CompletionError(
                    message=f"model {creq.model!r} not found; available: "
                            f"{self.backend.names()}",
                    param="model", code="model_not_found")
            return None
        if creq.model != self.model:
            return CompletionError(
                message=f"model {creq.model!r} not found; available: "
                        f"{[self.model]}",
                param="model", code="model_not_found")
        return None

    # ------------------------------------------------------------ plumbing
    def _pump(self, now: float | None) -> None:
        """One backend step; fan the emitted events into per-rid buffers."""
        st = self.backend.step(now)
        events = list(getattr(st, "events", None) or [])
        drain = getattr(self.backend, "drain_events", None)
        if drain is not None:
            events.extend(drain())
        for ev in events:
            if ev.rid in self._buffers:
                self._buffers[ev.rid].append(ev)

    def _submit(self, creq: CompletionRequest,
                now: float | None) -> Request:
        req = creq.to_request(next(self._rids))
        self._buffers[req.rid] = deque()
        self.backend.submit(req, now)
        return req

    def _chunk(self, req: Request, t: float, tokens: list[int],
               finish: str | None) -> CompletionChunk:
        return CompletionChunk(
            id=f"cmpl-{_trace_hex(req.rid)}", created=t,
            model=req.model or self.model,
            choices=[{"index": 0, "tokens": tokens,
                      "finish_reason": finish}])

    # ------------------------------------------------------------ sync path
    def create(self, creq: CompletionRequest, now: float | None = None,
               dt: float = 1.0,
               max_steps: int = 10_000) -> CompletionResponse | CompletionError:
        """Blocking completion: assembled from the same event stream the
        streaming path yields, then checked against ``Request.output``."""
        err = self._route_error(creq)
        if err is not None:
            return err
        t = now
        req = self._submit(creq, t)
        demux = StreamDemux()
        tokens: list[int] = []
        finish: str | None = None
        steps = 0
        try:
            while not req.done() and steps < max_steps:
                self._pump(t)
                if t is not None:
                    t += dt
                for ev in self._drain_buffer(req.rid):
                    if isinstance(ev, FinishEvent):
                        finish = ev.reason
                    else:
                        tokens.extend(tok.token for tok in demux.feed([ev]))
                steps += 1
        finally:
            self._buffers.pop(req.rid, None)
        if req.state is State.REJECTED:
            finish = "rejected"
        elif not req.done():
            raise RuntimeError(f"rid {req.rid} unfinished after "
                               f"{max_steps} steps")
        else:
            assert tokens == req.output, \
                "streamed tokens diverged from Request.output"
        created = time.time() if now is None else now
        # the response echoes the *endpoint* that served the request
        return CompletionResponse(
            id=f"cmpl-{_trace_hex(req.rid)}", created=created,
            model=creq.model,
            choices=[CompletionChoice(index=0, tokens=tokens,
                                      finish_reason=finish)],
            usage=CompletionUsage(prompt_tokens=len(creq.prompt),
                                  completion_tokens=len(tokens),
                                  total_tokens=len(creq.prompt) + len(tokens)),
            x_ttft=req.ttft, x_tpot=req.tpot, x_migrations=req.migrations,
            x_trace_id=_trace_hex(req.rid))

    # ------------------------------------------------------- streaming path
    def stream(self, creq: CompletionRequest, now: float | None = None,
               dt: float = 1.0,
               max_steps: int = 10_000) -> Iterator[CompletionChunk]:
        """Yield one chunk per emitted token, then a finish chunk.  Render
        frames with ``chunk.to_sse()`` (terminate with ``SSE_DONE``).  An
        unroutable model yields a single :class:`CompletionError` frame."""
        err = self._route_error(creq)
        if err is not None:
            yield err
            return
        t = now
        req = self._submit(creq, t)
        demux = StreamDemux()
        finish: str | None = None
        steps = 0
        try:
            while not req.done() and steps < max_steps:
                # only step the backend when this stream has nothing
                # buffered — interleaved streams pump for each other
                if not self._buffers[req.rid]:
                    self._pump(t)
                    if t is not None:
                        t += dt
                for ev in self._drain_buffer(req.rid):
                    if isinstance(ev, FinishEvent):
                        finish = ev.reason
                    elif isinstance(ev, PreemptEvent):
                        continue       # handoff/rollback: demux absorbs it
                    else:
                        for tok in demux.feed([ev]):
                            yield self._chunk(req, tok.t, [tok.token], None)
                steps += 1
            if req.state is State.REJECTED:
                finish = "rejected"
            elif not req.done():
                raise RuntimeError(f"rid {req.rid} unfinished after "
                                   f"{max_steps} steps")
            # a peer stream's pump can finish this request while this
            # generator isn't iterating — flush anything still buffered
            for ev in self._drain_buffer(req.rid):
                if isinstance(ev, FinishEvent):
                    finish = ev.reason
                elif isinstance(ev, TokenEvent):
                    for tok in demux.feed([ev]):
                        yield self._chunk(req, tok.t, [tok.token], None)
            yield self._chunk(req, req.t_finish if req.t_finish is not None
                              else (t if t is not None else time.time()),
                              [], finish or "length")
        finally:
            self._buffers.pop(req.rid, None)

    def _drain_buffer(self, rid: int) -> list[EngineEvent]:
        buf = self._buffers.get(rid)
        if not buf:
            return []
        out = list(buf)
        buf.clear()
        return out
