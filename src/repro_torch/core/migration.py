"""Transparent request migration (paper §3 'Migration technology').

Llumnix/DistServe-inspired: live requests move between replicas to
(a) rebalance load, (b) drain stragglers/failing nodes, (c) defragment KV
capacity.  The decision layer is shared by the simulator and the real
engines; the handoff itself is InferenceEngine.extract_row/adopt with a
transfer-time cost model:

    t_handoff = kv_bytes * concurrent / bw + overhead

bw = NVLink-class intra-node (the paper's testbed) or ICI/DCN on TPU pods;
``concurrent`` transfers sharing one link split its bandwidth.

Two execution paths share the probe/extract/convert/rollback logic:

* :meth:`MigrationManager.migrate` — the synchronous whole-payload
  handoff (extract_row -> adopt in one call), with the modeled cost.
* :meth:`MigrationManager.migrate_async` — the cloud-native path: the
  destination reserves its row and block plan up front
  (``begin_adopt``), then the payload streams over a
  :class:`~repro_torch.core.transport.Transport` link one block-granular chunk
  per message (``feed_adopt``), and the row activates
  (``commit_adopt``) as soon as the last chunk lands — transfer
  overlapped with compute on both replicas instead of stop-and-copy.
  ``duration_s`` on the resulting event is *measured* in transport steps,
  so link latency, serialization and contention all show up in it.

Payloads convert across KV backends (dense row -> destination blocks and
back); ``backend-mismatch`` remains only for genuinely unservable shapes
(cache leaves with no KV sequence axis — SSM state has no block form).
``dst-full`` refusals are tracked per request with capped exponential
backoff so the control plane retries them on a later tick instead of
abandoning the move.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.events import PreemptEvent
from repro_torch.serving.request import State


@dataclasses.dataclass
class MigrationConfig:
    imbalance_threshold: float = 0.35   # (max-min)/capacity occupancy gap
    straggler_speed: float = 0.5        # below this, drain the replica
    bandwidth_Bps: float = 200e9        # NVLink-ish; TPU ICI ~50e9/link
    overhead_s: float = 0.010
    # concurrent transfers allowed *per link* (per (src, dst) replica pair)
    max_concurrent: int = 2
    # capped exponential backoff for dst-full refusals: attempt k retries
    # after base * backoff^(k-1) steps, capped; abandoned past max_attempts
    retry_base_steps: float = 2.0
    retry_backoff: float = 2.0
    retry_cap_steps: float = 32.0
    retry_max_attempts: int = 5


@dataclasses.dataclass
class MigrationEvent:
    t: float
    rid: int
    src: int
    dst: int
    bytes: int                  # actually transferred (dst-cached blocks skipped)
    duration_s: float
    bytes_full: int = 0         # the request's full KV footprint at the source
    blocks_skipped: int = 0     # dst prefix-cache hits (paged only)
    phase: str = "decode"       # "decode" | "prefill" (chunk-boundary handoff)
    chunks: int = 1             # transfer granularity (async: one per block)


@dataclasses.dataclass
class MigrationFailure:
    t: float
    rid: int
    src: int
    dst: int
    reason: str                 # "dst-full" | "requeued" | "backend-mismatch"


@dataclasses.dataclass
class _AsyncTransfer:
    """One in-flight block-granular migration (extract done, commit pending)."""
    rid: int
    req: Any
    dst: InferenceEngine
    ticket: int
    payload: dict
    src_node: str
    dst_node: str
    src_idx: int
    dst_idx: int
    src_tracer: Any
    n_keep: int
    total: int                  # chunks to ship
    chunk_bytes: int
    nbytes: int
    nbytes_full: int
    phase: str
    t0: float                   # caller clock at initiation
    step0: int                  # transport clock at initiation
    sent: int = 0
    received: int = 0


class MigrationManager:
    #: transport message kind KV chunks travel under
    CHUNK_KIND = "kv_chunk"

    def __init__(self, cfg: MigrationConfig = MigrationConfig(),
                 transfer_span: str = "migration_transfer"):
        self.cfg = cfg
        # span name a successful handoff is annotated with on the request's
        # trace: "migration_transfer" for rebalance/drain moves,
        # "handoff" when the disaggregated server owns this manager
        self.transfer_span = transfer_span
        self.events: list[MigrationEvent] = []
        self.failures: list[MigrationFailure] = []
        self.attempted = 0
        # (dst_node, rid) -> in-flight async transfer
        self._inflight: dict[tuple[str, int], _AsyncTransfer] = {}
        # rid -> {"attempts", "next_try"} backoff state for dst-full refusals
        self._retry: dict[int, dict[str, float]] = {}
        self._m_attempts = self._m_success = self._m_failures = None
        self._m_bytes = self._m_bytes_full = self._m_blocks_skipped = None

    def attach_metrics(self, registry) -> None:
        """Bind migration instruments onto a cluster metrics registry."""
        self._m_attempts = registry.counter(
            "migration_attempts_total", "Handoffs attempted")
        self._m_success = registry.counter(
            "migration_success_total", "Handoffs completed, by phase",
            ("phase",))
        self._m_failures = registry.counter(
            "migration_failures_total", "Handoffs failed, by reason",
            ("reason",))
        self._m_bytes = registry.counter(
            "migration_bytes_total",
            "KV bytes actually transferred (dst-cached blocks skipped)")
        self._m_bytes_full = registry.counter(
            "migration_bytes_full_total",
            "Full KV footprint of migrated requests")
        self._m_blocks_skipped = registry.counter(
            "migration_blocks_skipped_total",
            "Blocks not shipped because the destination already cached them")

    @property
    def succeeded(self) -> int:
        return len(self.events)

    @property
    def failed(self) -> int:
        return len(self.failures)

    @property
    def transfers_in_flight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------ decision
    def plan(self, occupancies: Sequence[float],
             speeds: Sequence[float] | None = None) -> list[tuple[int, int]]:
        """Return (src_replica, dst_replica) moves given per-replica
        occupancy fractions (and optional speed factors for stragglers).
        At most ``max_concurrent`` moves per tick — which also caps every
        link at ``max_concurrent``, the number of transfers it carries
        concurrently.  (The cap is *enforced* per link at transfer time:
        ``migrate_async`` refuses a saturated link, and the sync path's
        ``concurrent`` argument stretches ``duration_s`` for moves that
        share one.)"""
        n = len(occupancies)
        if n < 2:
            return []
        moves: list[tuple[int, int]] = []
        occ = list(occupancies)
        speeds = list(speeds) if speeds is not None else [1.0] * n
        for _ in range(self.cfg.max_concurrent):
            # stragglers drain first
            stragglers = [i for i in range(n)
                          if speeds[i] < self.cfg.straggler_speed and occ[i] > 0]
            if stragglers:
                src = max(stragglers, key=lambda i: occ[i])
            else:
                src = max(range(n), key=lambda i: occ[i])
            dst = min(range(n), key=lambda i: occ[i] if speeds[i] >= 1.0 else 2.0)
            if src == dst:
                break
            if not stragglers and occ[src] - occ[dst] < self.cfg.imbalance_threshold:
                break
            moves.append((src, dst))
            delta = 1.0 / max(n, 1)
            occ[src] -= delta
            occ[dst] += delta
        return moves

    def transfer_time(self, nbytes: int, concurrent: int = 1) -> float:
        """Modeled handoff cost; ``concurrent`` transfers on the same link
        split its bandwidth, so each one serializes ``concurrent`` times
        slower (the async path doesn't use this — contention emerges from
        the transport's fair-share crediting and is *measured* instead)."""
        return nbytes * max(concurrent, 1) / self.cfg.bandwidth_Bps \
            + self.cfg.overhead_s

    # ------------------------------------------------------- retry/backoff
    def _note_refusal(self, rid: int, now: float) -> None:
        st = self._retry.setdefault(rid, {"attempts": 0, "next_try": 0.0})
        st["attempts"] += 1
        delay = min(self.cfg.retry_base_steps
                    * self.cfg.retry_backoff ** (st["attempts"] - 1),
                    self.cfg.retry_cap_steps)
        st["next_try"] = now + delay

    def retry_state(self, rid: int) -> dict[str, float] | None:
        return self._retry.get(rid)

    def clear_retry(self, rid: int) -> None:
        self._retry.pop(rid, None)

    def ready_to_retry(self, now: float) -> list[int]:
        """Requests whose dst-full backoff has elapsed and that still have
        retry budget — the control plane re-plans a move for each."""
        return [rid for rid, st in self._retry.items()
                if st["attempts"] < self.cfg.retry_max_attempts
                and st["next_try"] <= now]

    # ------------------------------------------------------------ execution
    def _fail(self, now: float, rid: int, src_idx: int, dst_idx: int,
              reason: str) -> None:
        self.failures.append(MigrationFailure(now, rid, src_idx, dst_idx, reason))
        if self._m_failures is not None:
            self._m_failures.inc(reason=reason)
        if reason == "dst-full":
            self._note_refusal(rid, now)
        elif reason == "requeued":
            # the request restarts from the queue; the old move is moot
            self.clear_retry(rid)

    def _probe(self, src: InferenceEngine, dst: InferenceEngine, rid: int):
        """Shared pre-transfer probe: payload size, and the full blocks the
        destination's prefix cache already holds (reused, never shipped)."""
        nbytes_full = src.kv_bytes(rid)
        nbytes, skipped = nbytes_full, 0
        if (getattr(src, "paged", False) and getattr(dst, "paged", False)
                and getattr(dst, "prefix_enabled", False)):
            seq = src.migration_sequence(rid)
            skipped = dst.prefix.lookup(seq) // dst.block_size
            nbytes = nbytes_full - skipped * src.kv_per_block_bytes()
        return nbytes, nbytes_full, skipped

    def _rollback(self, src: InferenceEngine, req, payload: dict, rid: int,
                  now: float, src_idx: int, dst_idx: int) -> None:
        """Destination refused after extraction: re-adopt at the source
        (with the *original* payload — its backend, not the converted one),
        or requeue from scratch if the source can't re-admit either — a
        live request is never dropped."""
        if src.adopt(req, payload, now):
            self._fail(now, rid, src_idx, dst_idx, "dst-full")
        else:
            # Appended directly: max_queue caps *new* arrivals, not a
            # rolled-back request that was already being served
            req.state = State.QUEUED
            req.row = None
            req.output.clear()
            req.token_times.clear()
            req.t_first_token = None
            req.t_admit = None
            req.preemptions += 1
            src.scheduler.queue.append(req)
            # the extract closed the phase span; the request is queued
            # again, so its trace re-enters queue residency here
            src.tracer.begin(rid, "queue_wait", now,
                             replica=getattr(src, "_rlabel", None),
                             requeued=True)
            # stream consumers: earlier token indices will be re-emitted
            # by whichever replica re-serves this request — the demux
            # drops them, keeping downstream streams append-only
            src.emit_event(PreemptEvent(t=now, rid=rid, reason="requeued"))
            self._fail(now, rid, src_idx, dst_idx, "requeued")

    def _record(self, ev: MigrationEvent, rid: int, dst: InferenceEngine,
                src_tracer, now: float, skipped: int) -> None:
        self.events.append(ev)
        self.clear_retry(rid)
        # the KV handoff on the request's trace: an instant span on the step
        # clock carrying the transfer cost as an attribute (the attribution
        # report charges duration_s to the migration bucket)
        dst.tracer.annotate(rid, self.transfer_span, now,
                            replica=getattr(dst, "_rlabel", None),
                            src=ev.src, dst=ev.dst, bytes=ev.bytes,
                            bytes_full=ev.bytes_full, blocks_skipped=skipped,
                            duration_s=ev.duration_s, chunks=ev.chunks)
        if src_tracer is not dst.tracer:
            # replicas with independent tracers each keep their slice of the
            # trace (same trace id, disjoint span ids); close the source's
            # so no span is left open on a replica that no longer serves it
            src_tracer.finish(rid, now, status="migrated-out")
        if self._m_attempts is not None:
            self._m_success.inc(phase=ev.phase)
            self._m_bytes.inc(ev.bytes)
            self._m_bytes_full.inc(ev.bytes_full)
            self._m_blocks_skipped.inc(skipped)

    def _converted(self, dst: InferenceEngine, req, payload: dict):
        """Payload in the destination's backend layout (identity when the
        backends already match)."""
        want = "paged" if getattr(dst, "paged", False) else "dense"
        if payload.get("kind", "dense") == want:
            return payload
        return dst.convert_payload(req, payload)

    def migrate(self, src: InferenceEngine, dst: InferenceEngine, rid: int,
                now: float, src_idx: int = 0, dst_idx: int = 1,
                concurrent: int = 1) -> MigrationEvent | None:
        """Real engine-to-engine handoff (same model config/max_len).

        Paged replicas hand off their block table: the destination is probed
        first, so blocks whose token content its prefix cache already holds
        are never transferred — a prefix-cache-hot request moves fewer bytes
        than its full KV footprint.  Dense<->paged pairs convert the payload
        in flight; only genuinely unservable shapes (no KV sequence axis to
        blockify) are recorded as ``backend-mismatch`` and skipped.

        A destination refusal (no row / no admissible block plan) rolls the
        request back into the source.  If the source *also* cannot re-admit
        — its row or blocks were claimed meanwhile — the request is requeued
        at the source scheduler from scratch rather than silently dropped
        (on a paged source its prompt KV was donated to the prefix index at
        extraction, so the re-prefill is mostly cache hits).  Every failure
        is recorded in :attr:`failures` with a reason; ``dst-full`` arms the
        retry backoff.  ``concurrent``: how many transfers share this link
        this tick — their modeled durations stretch accordingly."""
        self.attempted += 1
        if self._m_attempts is not None:
            self._m_attempts.inc()
        if getattr(src, "paged", False) != getattr(dst, "paged", False) \
                and not dst.can_convert(src):
            self._fail(now, rid, src_idx, dst_idx, "backend-mismatch")
            return None
        _, live_req, _ = src._find_row(rid)
        n_valid = len(src.migration_sequence(rid))
        nbytes, nbytes_full, skipped = self._probe(src, dst, rid)
        if not dst.can_adopt(live_req, n_valid, skipped):
            # cheap refusal: no KV was gathered, nothing to roll back —
            # a drain loop can retry every tick at O(1) cost
            self._fail(now, rid, src_idx, dst_idx, "dst-full")
            return None
        req, payload = src.extract_row(rid, now=now)
        converted = self._converted(dst, req, payload)
        if converted is None or not dst.adopt(req, converted, now):
            self._rollback(src, req, payload, rid, now, src_idx, dst_idx)
            return None
        ev = MigrationEvent(now, rid, src_idx, dst_idx, nbytes,
                            self.transfer_time(nbytes, concurrent),
                            bytes_full=nbytes_full,
                            blocks_skipped=skipped, phase=payload["phase"])
        self._record(ev, rid, dst, src.tracer, now, skipped)
        return ev

    # ------------------------------------------------- async (transported)
    def link_active(self, src_node: str, dst_node: str) -> int:
        return sum(1 for tr in self._inflight.values()
                   if tr.src_node == src_node and tr.dst_node == dst_node)

    def migrate_async(self, src: InferenceEngine, dst: InferenceEngine,
                      rid: int, now: float, transport, src_node: str,
                      dst_node: str, src_idx: int = 0,
                      dst_idx: int = 1) -> bool:
        """Start a block-granular handoff over a transport link: probe and
        extract at the source, reserve the row + block plan at the
        destination (``begin_adopt``), then hand the payload to
        :meth:`pump`, which streams one chunk per message under the link's
        backpressure.  The destination activates the row the moment the
        last chunk lands — both replicas keep stepping meanwhile.

        Returns True when the transfer is in flight.  False: the link
        already carries ``max_concurrent`` transfers (not a failure — retry
        next tick), or the same refusals as :meth:`migrate` (recorded in
        :attr:`failures`, dst-full arming the backoff).  Chunks travel
        reliably: faults injected on the unreliable class never corrupt KV,
        and a partition stalls — never kills — an in-flight adoption."""
        if self.link_active(src_node, dst_node) >= self.cfg.max_concurrent:
            return False
        if any(tr.rid == rid for tr in self._inflight.values()):
            return False
        self.attempted += 1
        if self._m_attempts is not None:
            self._m_attempts.inc()
        if getattr(src, "paged", False) != getattr(dst, "paged", False) \
                and not dst.can_convert(src):
            self._fail(now, rid, src_idx, dst_idx, "backend-mismatch")
            return False
        _, live_req, _ = src._find_row(rid)
        n_valid = len(src.migration_sequence(rid))
        nbytes, nbytes_full, skipped = self._probe(src, dst, rid)
        if not dst.can_adopt(live_req, n_valid, skipped):
            self._fail(now, rid, src_idx, dst_idx, "dst-full")
            return False
        req, payload = src.extract_row(rid, now=now)
        converted = self._converted(dst, req, payload)
        ticket = None
        if converted is not None:
            ticket = dst.begin_adopt(req, converted, now)
        if ticket is None:
            self._rollback(src, req, payload, rid, now, src_idx, dst_idx)
            return False
        st = dst._pending_adopt[ticket]
        if converted.get("kind") == "paged":
            total = st["expected"]
            chunk_bytes = dst.kv_per_block_bytes()
            nbytes = chunk_bytes * total    # post-plan truth (n_keep reused)
            skipped = st["n_keep"]
        else:
            total, chunk_bytes = 1, nbytes
        transport.register(dst_node, self.CHUNK_KIND, self._on_chunk)
        self._inflight[(dst_node, rid)] = _AsyncTransfer(
            rid=rid, req=req, dst=dst, ticket=ticket, payload=converted,
            src_node=src_node, dst_node=dst_node, src_idx=src_idx,
            dst_idx=dst_idx, src_tracer=src.tracer, n_keep=st["n_keep"],
            total=total, chunk_bytes=chunk_bytes, nbytes=nbytes,
            nbytes_full=nbytes_full, phase=payload["phase"], t0=now,
            step0=transport.now)
        self.pump(now, transport)
        return True

    def _chunk_data(self, tr: _AsyncTransfer, i: int):
        """Transfer chunk ``i``: the whole row cache on the dense backend,
        else payload block ``n_keep + i`` of every layer pool (the block
        axis leads each per-layer slab)."""
        if tr.payload.get("kind") != "paged":
            return tr.payload["caches"]
        j = tr.n_keep + i
        return [{n: t[j:j + 1] for n, t in layer.items()}
                for layer in tr.payload["blocks"]]

    def pump(self, now: float, transport) -> int:
        """Push pending chunks of every in-flight transfer onto their links,
        stopping per transfer at the first backpressured send.  Called once
        per control-plane step.  Returns chunks enqueued."""
        pushed = 0
        for tr in list(self._inflight.values()):
            while tr.sent < tr.total:
                data = self._chunk_data(tr, tr.sent)
                ok = transport.send(
                    tr.src_node, tr.dst_node, self.CHUNK_KIND,
                    {"rid": tr.rid, "i": tr.sent, "data": data},
                    size_bytes=tr.chunk_bytes, reliable=True)
                if not ok:
                    break
                tr.sent += 1
                pushed += 1
        return pushed

    def _on_chunk(self, msg, step_now: int) -> None:
        p = msg.payload
        tr = self._inflight.get((msg.dst, p["rid"]))
        if tr is None:
            return
        tr.dst.feed_adopt(tr.ticket, p["i"], p["data"])
        tr.received += 1
        # map the transport clock back onto the caller's step clock
        now = tr.t0 + (step_now - tr.step0)
        tr.dst.tracer.annotate(tr.rid, f"{self.transfer_span}_chunk", now,
                               replica=getattr(tr.dst, "_rlabel", None),
                               chunk=p["i"], chunks=tr.total,
                               bytes=tr.chunk_bytes,
                               src=tr.src_idx, dst=tr.dst_idx)
        if tr.received < tr.total:
            return
        del self._inflight[(msg.dst, p["rid"])]
        tr.dst.commit_adopt(tr.ticket, now)
        ev = MigrationEvent(tr.t0, tr.rid, tr.src_idx, tr.dst_idx, tr.nbytes,
                            duration_s=float(step_now - tr.step0),
                            bytes_full=tr.nbytes_full,
                            blocks_skipped=tr.n_keep, phase=tr.phase,
                            chunks=tr.total)
        self._record(ev, tr.rid, tr.dst, tr.src_tracer, now, tr.n_keep)

    def pick_request(self, eng: InferenceEngine,
                     include_prefill: bool = True) -> int | None:
        """Cheapest-to-move live request — smallest materialised KV
        (``pos``), so the handoff moves the least data and loses the least
        progress if it fails.  Candidates come from
        :meth:`InferenceEngine.migratable_requests`: decode rows plus, when
        ``include_prefill``, chunk-boundary mid-prefill rows — the payload
        carries the prefill progress, so adopting one resumes its remaining
        prompt instead of truncating it into a bogus decode."""
        cands = eng.migratable_requests()
        if not include_prefill:
            cands = [r for r in cands if r.state is State.DECODE]
        if not cands:
            return None
        req = min(cands, key=lambda r: int(eng.pos[r.row]))
        return req.rid
