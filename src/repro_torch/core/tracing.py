"""Request-lifecycle distributed tracing on the serving step clock.

One trace per request (trace id = rid), spans recorded at the engine's
request-visible transitions:

    request                 root: submit -> finish (status ok/rejected)
      queue_wait            scheduler queue residency (re-opens on requeue)
      admission             instant: row/bucket assignment, cached-prefix hits
      prefill               admission -> first token (re-opens after preempt)
        prefill_chunk[k]    instant child: one chunked-prefill slice
      decode                first token -> retire (re-opens on the dst replica)
      slo_guard_preempt     instant: SLO guard displaced this mid-prefill row
      migration_transfer    instant: KV handoff (bytes, modeled duration)
      handoff               instant: disaggregated prefill->decode transfer

``queue_wait`` / ``prefill`` / ``decode`` are the *phase* spans: they tile
the request's lifetime end to end (each opens exactly when the previous one
closes), which is what :meth:`Tracer.verify` and :meth:`Tracer.gaps` check
and what the SLO-miss attribution integrates over.  Everything else is an
instant annotation hanging off the root.

Cross-replica continuity: a migration payload carries
:meth:`Tracer.export_context` and the destination calls
:meth:`Tracer.import_context`, so span ids keep counting monotonically and
a migrated request yields ONE contiguous trace spanning both replicas —
whether the replicas share a Tracer (orchestrator) or not.

Step spans: one ``engine.step`` span a step of the engine, with its phases
as children in the order a step runs them (``STEP_PHASES``).  The engine
times its phases on a :class:`StepClock` whether or not anything is
recorded; with ``Tracer.record_steps`` on, and on every step that runs
while a ``torch.profiler`` runs, each phase is also a span on
``time.perf_counter`` and, for the chunk forward and the samplers on a
CUDA device, a pair of CUDA events around their launches.  Their
``device_ms`` is the stream's time between the two marks: the device's
time for the phase where the device runs behind the host, the host's
launch time where the device waits for it.  It is read once the device
has passed both marks, never by a synchronise of its own.  While a
profiler runs, each span is also a ``torch.profiler.record_function``
range, so a profiled slice shows it beside the device's kernels; outside
one nothing would read a range, and none is opened.  The spans of the
last ``step_capacity`` steps are kept.

Exports: :meth:`Tracer.chrome_trace` renders Chrome/Perfetto trace-event
JSON (``ph: "X"`` complete events, microsecond timestamps, pid = replica,
tid = rid, and a ``steps`` track a replica — load the file straight into
https://ui.perfetto.dev), and :func:`attribute_slo_misses` decomposes each
missed ``slo_ttft``/``slo_tpot`` into queue-wait vs prefill vs
decode-stall vs migration time.

Host-side Python only (no jax, no serving imports): the serving layer
imports this lazily, keeping the core<->serving import graph acyclic.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Iterable

import torch

#: span names whose closed intervals must tile a request's lifetime
PHASES = ("queue_wait", "prefill", "decode")

#: attribution bucket per span family (``prefill_chunk[k]`` -> ``prefill_chunk``)
PHASE_BUCKET = {
    "queue_wait": "queue_wait",
    "prefill": "prefill",
    "admission": "prefill",
    "prefill_chunk": "prefill",
    "migration_transfer": "migration",
    "handoff": "migration",
}


#: the children of an ``engine.step`` span, in the order a step runs them,
#: each with the ``engine_step_seconds`` phase its host time counts to
STEP_PHASES = {
    "engine.admit": "admit",
    "engine.chunk.prepare": "chunk",
    "engine.chunk.forward": "chunk",
    "engine.chunk.sample": "sample",
    "engine.decode.prepare": "decode",
    "engine.decode.forward": "decode",
    "engine.decode.sample": "sample",
    "engine.decode.wait": "sample",
    "engine.emit": "emit",
}

#: the phases whose host time ``StepStats.prefill_s`` and ``decode_s`` add
STEP_STATS = {
    "prefill_s": ("engine.admit", "engine.chunk.prepare",
                  "engine.chunk.forward", "engine.chunk.sample"),
    "decode_s": ("engine.decode.prepare", "engine.decode.forward",
                 "engine.decode.sample", "engine.decode.wait"),
}

#: the Chrome trace's thread id of a replica's ``steps`` track
STEPS_TID = 2 ** 31 - 1


def trace_id_hex(rid: int) -> str:
    """The wire form of a trace id: the rid as a 16-hex-digit string (the
    shape OpenTelemetry trace ids take), joinable from API responses."""
    return f"{rid & (2 ** 64 - 1):016x}"


def _base(name: str) -> str:
    return name.split("[", 1)[0]


@dataclasses.dataclass
class Span:
    trace_id: int                   # == rid
    span_id: int
    name: str
    t0: float
    t1: float | None = None         # None while open
    parent_id: int | None = None
    replica: str | None = None
    status: str = "ok"
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


class _Trace:
    __slots__ = ("rid", "spans", "next_span", "root_id", "incarnation",
                 "chunks")

    def __init__(self, rid: int, next_span: int = 0,
                 root_id: int | None = None, incarnation: int = 0):
        self.rid = rid
        self.spans: list[Span] = []
        self.next_span = next_span
        self.root_id = root_id
        self.incarnation = incarnation
        self.chunks = 0             # prefill_chunk[k] annotations so far


class Tracer:
    """Per-request span store.  Every mutator is tolerant of an unknown rid
    (returns ``None``): observability must never crash the serving path.

    Engines in one cluster share a Tracer (the orchestrator hands its own
    to every replica), so a migrated request's spans land in the same trace
    naturally; independent Tracers stay contiguous through
    export_context/import_context carried in the migration payload.

    ``record_steps`` (off by default) switches the engines' step spans on;
    a shared Tracer switches them for every replica.  A step that runs
    while a ``torch.profiler`` runs is recorded whatever the switch, so a
    profile carries the phases its kernels are read against.
    """

    #: steps whose spans the ring keeps
    step_capacity = 8192

    def __init__(self):
        self._live: dict[int, _Trace] = {}
        self._archive: list[_Trace] = []
        self.record_steps = False
        self._steps: collections.deque[list[Span]] = collections.deque(
            maxlen=self.step_capacity)
        self._step_no = 0
        # (span, start, end) CUDA events the device has not passed yet
        self._pending: list[tuple[Span, Any, Any]] = []

    # ------------------------------------------------------------ lifecycle
    def start_trace(self, rid: int, t: float, replica: str | None = None,
                    **attrs) -> Span:
        """Open (or re-enter) the trace for ``rid``.

        A live trace whose root is still open is returned as-is — resubmits
        of a live request (scale-down drain, rollback requeue) must continue
        the same trace.  A live trace whose root has *closed* means the rid
        is being reused by a new request (benches recycle rids across
        sweeps): the finished trace is archived and a fresh incarnation
        starts."""
        tr = self._live.get(rid)
        if tr is not None:
            root = self._span(tr, tr.root_id)
            if root is not None and root.open:
                return root
            self._archive.append(tr)
            tr = _Trace(rid, incarnation=tr.incarnation + 1)
            self._live[rid] = tr
        else:
            tr = _Trace(rid)
            self._live[rid] = tr
        root = self._open(tr, "request", t, parent_id=None, replica=replica,
                          attrs=attrs)
        tr.root_id = root.span_id
        return root

    def begin(self, rid: int, name: str, t: float,
              replica: str | None = None, **attrs) -> Span | None:
        tr = self._live.get(rid)
        if tr is None:
            return None
        return self._open(tr, name, t, parent_id=tr.root_id, replica=replica,
                          attrs=attrs)

    def end(self, rid: int, name: str, t: float, status: str = "ok",
            **attrs) -> Span | None:
        """Close the most recent open span named ``name`` (no-op when none
        is open — preempt/rollback paths may race a span already closed)."""
        tr = self._live.get(rid)
        if tr is None:
            return None
        for s in reversed(tr.spans):
            if s.open and s.name == name:
                s.t1 = t
                s.status = status
                s.attrs.update(attrs)
                return s
        return None

    def annotate(self, rid: int, name: str, t: float, duration: float = 0.0,
                 replica: str | None = None, **attrs) -> Span | None:
        """Record an already-finished (instant) span."""
        tr = self._live.get(rid)
        if tr is None:
            return None
        s = self._open(tr, name, t, parent_id=tr.root_id, replica=replica,
                       attrs=attrs)
        s.t1 = t + duration
        return s

    def finish(self, rid: int, t: float, status: str = "ok") -> Span | None:
        """Close the trace: every still-open span (root included) closes at
        ``t`` with ``status`` — the retire/reject paths never orphan."""
        tr = self._live.get(rid)
        if tr is None:
            return None
        root = None
        for s in tr.spans:
            if s.open:
                s.t1 = t
                if s.span_id == tr.root_id:
                    s.status = status
                    root = s
                elif status != "ok":
                    s.status = status
        return root

    # ------------------------------------------------------------- queries
    def _span(self, tr: _Trace, span_id: int | None) -> Span | None:
        if span_id is None:
            return None
        for s in tr.spans:
            if s.span_id == span_id:
                return s
        return None

    def _open(self, tr: _Trace, name: str, t: float, parent_id: int | None,
              replica: str | None, attrs: dict) -> Span:
        s = Span(trace_id=tr.rid, span_id=tr.next_span, name=name, t0=t,
                 parent_id=parent_id, replica=replica, attrs=dict(attrs))
        tr.next_span += 1
        tr.spans.append(s)
        return s

    def spans(self, rid: int) -> list[Span]:
        """The live trace's spans for ``rid`` (empty when unknown)."""
        tr = self._live.get(rid)
        return list(tr.spans) if tr is not None else []

    def open_span(self, rid: int, name: str) -> Span | None:
        tr = self._live.get(rid)
        if tr is None:
            return None
        for s in reversed(tr.spans):
            if s.open and s.name == name:
                return s
        return None

    def annotate_chunk(self, rid: int, t: float, replica: str | None = None,
                       **attrs) -> Span | None:
        """Record the trace's next ``prefill_chunk[k]`` instant: k counts
        the live trace's chunks across replicas sharing this Tracer and
        preempt restarts."""
        tr = self._live.get(rid)
        if tr is None:
            return None
        tr.chunks += 1
        return self.annotate(rid, f"prefill_chunk[{tr.chunks - 1}]", t,
                             replica=replica, **attrs)

    def traces(self) -> Iterable[_Trace]:
        yield from self._archive
        yield from self._live.values()

    # ---------------------------------------------------------- step spans
    def step_clock(self, now: float, replica: str | None = None,
                   cuda: bool = False) -> StepClock:
        """The stopwatch of one engine step (``now``: the step's clock
        value); it records the step's spans while ``record_steps`` is on
        or a profiler runs, with CUDA events on the device phases where
        ``cuda``, and ranges while a profiler runs."""
        profiled = torch._C._autograd._profiler_enabled()
        if not (self.record_steps or profiled):
            return StepClock()
        return StepClock(_StepRecorder(self, now, replica, cuda, profiled))

    def step_spans(self) -> list[list[Span]]:
        """The kept steps, oldest first: each its ``engine.step`` span, then
        its phases in order.  A device phase's ``device_ms`` is filled here
        or at the end of a later step, once the device has passed both its
        events (``Event.query``); None until then."""
        self._resolve()
        return list(self._steps)

    def _resolve(self) -> None:
        keep = []
        for span, e0, e1 in self._pending:
            if e1.query():
                span.attrs["device_ms"] = e0.elapsed_time(e1)
            else:
                keep.append((span, e0, e1))
        self._pending = keep

    # ------------------------------------------------ cross-replica context
    def export_context(self, rid: int) -> dict | None:
        """Span context a migration payload carries: enough for the
        destination's Tracer to continue this trace contiguously."""
        tr = self._live.get(rid)
        if tr is None:
            return None
        return {"rid": rid, "next_span": tr.next_span,
                "root_id": tr.root_id, "incarnation": tr.incarnation}

    def import_context(self, ctx: dict | None) -> None:
        """Adopt a trace context on the destination replica.  A no-op when
        this Tracer already holds the live trace (shared-Tracer cluster);
        otherwise the trace state is recreated with the span counter offset
        so ids never collide with the source's."""
        if ctx is None:
            return
        rid = ctx["rid"]
        if rid in self._live:
            return
        self._live[rid] = _Trace(rid, next_span=ctx["next_span"],
                                 root_id=ctx.get("root_id"),
                                 incarnation=ctx.get("incarnation", 0))

    # ------------------------------------------------------------ integrity
    def verify(self, rid: int | None = None) -> list[str]:
        """Trace-integrity violations (empty list = clean): any span still
        open, or two phase spans of one trace genuinely overlapping (shared
        endpoints are the normal tiling and are fine)."""
        problems = []
        if rid is not None:
            trs: Iterable[_Trace] = ([self._live[rid]]
                                     if rid in self._live else [])
        else:
            trs = self.traces()
        for tr in trs:
            for s in tr.spans:
                if s.open:
                    problems.append(f"rid {tr.rid}: span {s.name!r} "
                                    f"(id {s.span_id}) never closed")
            phase = sorted((s for s in tr.spans
                            if s.name in PHASES and not s.open),
                           key=lambda s: (s.t0, s.t1))
            for a, b in zip(phase, phase[1:]):
                if b.t0 < a.t1 - 1e-12:
                    problems.append(
                        f"rid {tr.rid}: phase spans overlap — "
                        f"{a.name}[{a.t0},{a.t1}] vs {b.name}[{b.t0},{b.t1}]")
        return problems

    def gaps(self, rid: int, tol: float = 1e-9) -> list[tuple[float, float]]:
        """Uncovered intervals between consecutive phase spans of the live
        trace for ``rid`` — a gapless trace returns ``[]``."""
        tr = self._live.get(rid)
        if tr is None:
            return []
        phase = sorted((s for s in tr.spans
                        if s.name in PHASES and not s.open),
                       key=lambda s: (s.t0, s.t1))
        out = []
        for a, b in zip(phase, phase[1:]):
            if b.t0 - a.t1 > tol:
                out.append((a.t1, b.t0))
        return out

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """Chrome/Perfetto trace-event JSON: one complete (``ph: "X"``)
        event per span, timestamps in microseconds, pid = replica,
        tid = rid; the kept step spans on each replica's ``steps`` track
        (tid ``STEPS_TID``).  Archived incarnations are included."""
        events: list[dict] = []
        pids: dict[int, str] = {}
        tids: set[tuple[int, int]] = set()

        def pid_of(replica) -> int:
            try:
                pid = int(replica) if replica is not None else 0
            except ValueError:
                pid = abs(hash(replica)) % 1000
            pids.setdefault(pid, f"replica {replica}"
                            if replica is not None else "replica ?")
            return pid

        for tr in self.traces():
            for s in tr.spans:
                pid = pid_of(s.replica)
                tids.add((pid, tr.rid))
                t1 = s.t0 if s.t1 is None else s.t1
                args = dict(s.attrs)
                args.update(trace_id=trace_id_hex(tr.rid), span_id=s.span_id,
                            status=s.status, incarnation=tr.incarnation)
                if s.parent_id is not None:
                    args["parent_id"] = s.parent_id
                events.append({
                    "name": s.name, "cat": _base(s.name), "ph": "X",
                    "ts": s.t0 * 1e6, "dur": max(t1 - s.t0, 0.0) * 1e6,
                    "pid": pid, "tid": tr.rid, "args": args,
                })
        step_pids = set()
        for spans in self.step_spans():
            for s in spans:
                pid = pid_of(s.replica)
                step_pids.add(pid)
                args = dict(s.attrs, step=s.trace_id, span_id=s.span_id)
                if s.parent_id is not None:
                    args["parent_id"] = s.parent_id
                events.append({
                    "name": s.name, "cat": "step", "ph": "X",
                    "ts": s.t0 * 1e6, "dur": max(s.duration, 0.0) * 1e6,
                    "pid": pid, "tid": STEPS_TID, "args": args,
                })
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": label}}
                for pid, label in sorted(pids.items())]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": rid,
                  "args": {"name": f"rid {rid}"}}
                 for pid, rid in sorted(tids)]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid,
                  "tid": STEPS_TID, "args": {"name": "steps"}}
                 for pid in sorted(step_pids)]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ------------------------------------------------------------ step clock
class StepClock:
    """One engine step's phases on the host clock.  ``enter(name)`` ends
    the running phase and starts ``name`` (a key of ``STEP_PHASES``);
    ``leave()`` ends it; ``finish(**attrs)`` ends the step.  ``seconds``
    adds each phase's host time by name, recording or not.  Recording makes
    each phase a span as well; off, a phase costs a clock reading and the
    one check of ``_rec``."""

    __slots__ = ("seconds", "_name", "_t", "_rec")

    def __init__(self, rec: _StepRecorder | None = None):
        self.seconds: dict[str, float] = {}
        self._name: str | None = None
        self._t = 0.0
        self._rec = rec

    @property
    def recording(self) -> bool:
        return self._rec is not None

    @property
    def ranges(self) -> bool:
        """Whether this step opens ``record_function`` ranges: it records
        and a profiler runs."""
        return self._rec is not None and self._rec.ranges

    def _stop(self) -> float:
        t = time.perf_counter()
        if self._name is not None:
            self.seconds[self._name] = (self.seconds.get(self._name, 0.0)
                                        + t - self._t)
            self._name = None
        return t

    def enter(self, name: str, device: bool = False) -> None:
        """Start phase ``name``; ``device``: time it on the device too."""
        t = self._stop()
        self._name, self._t = name, t
        if self._rec is not None:
            self._rec.enter(name, t, device)

    def end_device(self) -> None:
        """Mark the end of the running phase's device work, before the
        host goes on to wait for it within the phase."""
        if self._rec is not None:
            self._rec.end_device()

    def leave(self) -> None:
        t = self._stop()
        if self._rec is not None:
            self._rec.leave(t)

    def stats(self) -> dict[str, float]:
        """Host seconds of the phases so far by ``StepStats`` field
        (``STEP_STATS``)."""
        return {field: sum(self.seconds.get(n, 0.0) for n in names)
                for field, names in STEP_STATS.items()}

    def phases(self) -> dict[str, float]:
        """Host seconds by ``engine_step_seconds`` phase of the phases
        entered, the running one up to now."""
        out: dict[str, float] = {}
        for name, s in self.seconds.items():
            out[STEP_PHASES[name]] = out.get(STEP_PHASES[name], 0.0) + s
        if self._name is not None:
            ph = STEP_PHASES[self._name]
            out[ph] = out.get(ph, 0.0) + time.perf_counter() - self._t
        return out

    def finish(self, **attrs) -> None:
        """End the step; ``attrs`` go on its ``engine.step`` span."""
        t = self._stop()
        if self._rec is not None:
            self._rec.finish(t, attrs)
            self._rec = None

    def close(self) -> None:
        """End the ranges of a step that raised (a no-op once finished)."""
        if self._rec is not None:
            self._rec.abort()
            self._rec = None


class _StepRecorder:
    """The spans of a running step: ``engine.step`` first, then its phases;
    a device phase's start event until its end is recorded; while a
    profiler runs (``ranges``, read once a step), each open span's
    ``record_function`` range."""

    __slots__ = ("tracer", "cuda", "spans", "ranges", "open", "start")

    def __init__(self, tracer: Tracer, now: float, replica: str | None,
                 cuda: bool, ranges: bool):
        self.tracer, self.cuda, self.ranges = tracer, cuda, ranges
        self.open: list = []
        self._range("engine.step")
        self.spans = [Span(trace_id=tracer._step_no, span_id=0,
                           name="engine.step", t0=time.perf_counter(),
                           replica=replica, attrs={"now": now})]
        tracer._step_no += 1
        self.start = None

    def _range(self, name: str) -> None:
        if self.ranges:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.open.append(rf)

    def enter(self, name: str, t: float, device: bool) -> None:
        self.leave(t)
        self._range(name)
        step = self.spans[0]
        self.spans.append(Span(trace_id=step.trace_id, span_id=len(self.spans),
                               name=name, t0=t, parent_id=0,
                               replica=step.replica))
        if device and self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def end_device(self) -> None:
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            span = self.spans[-1]
            span.attrs["device_ms"] = None
            self.tracer._pending.append((span, self.start, end))
            self.start = None

    def leave(self, t: float) -> None:
        span = self.spans[-1]
        if span.span_id == 0 or span.t1 is not None:
            return
        self.end_device()
        if self.ranges:
            self.open.pop().__exit__(None, None, None)
        span.t1 = t

    def finish(self, t: float, attrs: dict) -> None:
        self.leave(t)
        step = self.spans[0]
        step.attrs.update(attrs)
        step.t1 = t
        self.abort()
        self.tracer._steps.append(self.spans)
        self.tracer._resolve()

    def abort(self) -> None:
        while self.open:
            self.open.pop().__exit__(None, None, None)


# ------------------------------------------------------- SLO-miss attribution
def _phase_sums(spans: list[Span], a: float, b: float) -> dict[str, float]:
    """Time each attribution bucket spent inside window [a, b]: closed-span
    durations clipped to the window, plus any modeled transfer duration
    (``duration_s``) an instant migration span carries."""
    sums = {"queue_wait": 0.0, "prefill": 0.0, "migration": 0.0}
    for s in spans:
        bucket = PHASE_BUCKET.get(_base(s.name))
        if bucket is None or s.t1 is None:
            continue
        if bucket == "prefill" and _base(s.name) != "prefill":
            continue            # admission/chunks are children of prefill
        clip = min(s.t1, b) - max(s.t0, a)
        if clip > 0:
            sums[bucket] += clip
        if bucket == "migration" and a <= s.t0 <= b:
            sums[bucket] += float(s.attrs.get("duration_s", 0.0))
    return sums


def attribute_slo_misses(tracer: Tracer, requests) -> list[dict]:
    """Decompose each missed ``slo_ttft``/``slo_tpot`` into where the time
    went: queue-wait vs prefill vs decode-stall vs migration.

    TTFT misses integrate over [arrival, first token]; TPOT misses over
    [first token, last token].  ``decode_stall`` is the residual — window
    time not accounted to the other buckets (for TPOT that is decode
    compute plus any stall behind co-batched prefill; for TTFT it is ~0).
    One row per miss: phase seconds, the dominant phase, and the trace id.
    """
    rows = []
    for r in requests:
        spans = tracer.spans(r.rid)
        if not spans:
            continue
        windows = []
        if (r.slo_ttft is not None and r.ttft is not None
                and r.ttft > r.slo_ttft):
            windows.append(("ttft", r.slo_ttft, r.ttft,
                            r.arrival, r.t_first_token))
        if (r.slo_tpot is not None and r.tpot is not None
                and r.tpot > r.slo_tpot):
            windows.append(("tpot", r.slo_tpot, r.tpot,
                            r.token_times[0], r.token_times[-1]))
        for kind, target, actual, a, b in windows:
            sums = _phase_sums(spans, a, b)
            window = max(b - a, 0.0)
            stall = max(window - sum(sums.values()), 0.0)
            parts = {**sums, "decode_stall": stall}
            rows.append({
                "rid": r.rid, "trace_id": trace_id_hex(r.rid), "slo": kind,
                "target": target, "actual": actual,
                "queue_wait": parts["queue_wait"],
                "prefill": parts["prefill"],
                "decode_stall": parts["decode_stall"],
                "migration": parts["migration"],
                "dominant": max(parts, key=lambda k: parts[k]),
            })
    rows.sort(key=lambda r: -(r["actual"] - r["target"]))
    return rows
