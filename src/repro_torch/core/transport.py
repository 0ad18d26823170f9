"""Simulated cluster transport (ROADMAP "Distribute the cache directory
and the KV plane").

A message-passing fabric on the logical step clock.  Nodes are string
names ("ctrl", "r0", ...); a *link* is the directed (src, dst) pair, with
modeled latency (steps), bandwidth (bytes per step) and a bounded
in-flight queue — ``send`` returns False when the queue is full, which is
the backpressure signal senders must handle.  Concurrent messages on one
link share its bandwidth fairly, so k overlapping transfers each
serialize at B/k bytes per step and take k times longer — link contention
is modeled, not assumed away.

Messages travel in two classes.  *Reliable* messages (KV chunks, replica
teardown) are never lost or reordered — only delayed by latency,
serialization and partitions.  *Unreliable* messages (cache-directory
deltas and reconciles — gossip-grade metadata) are subject to the
injectable faults in :class:`FaultSpec`: drop (vanishes at send, the
sender cannot tell), duplicate (delivered twice), reorder (a deliverable
message is pushed behind later traffic).  Partitions stall both classes
bidirectionally until healed; nothing queued is lost.

Delivery: ``step()`` advances the clock one step, credits each queued
message its fair bandwidth share, and delivers — in FIFO order per link —
every head-of-line message whose latency has elapsed and whose bytes are
fully serialized, dispatching the handler registered for (dst, kind).

:class:`DirectoryTransportClient` / :class:`DirectoryTransportService`
put the cluster cache directory's delta-sink protocol on this fabric: the
client is a drop-in replica-side sink (same duck-typed surface
``engine.attach_cache_directory`` expects) publishing deltas as
unreliable messages; the service applies delivered messages to the real
directory, using per-replica sequence numbers so a delta or reconcile
that arrives *behind* a newer reconcile snapshot is ignored rather than
resurrecting state the snapshot already superseded.  The conservative-
subset invariant then holds on the *delivered* view whenever anti-entropy
quiesces, which is exactly the paper's staleness-tolerant metadata story:
routing runs on a stale view, reconciles repair whatever the network ate.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass
class LinkSpec:
    """One direction of a point-to-point link."""
    latency_steps: int = 1          # steps between send and earliest delivery
    bandwidth: float = math.inf     # bytes serialized per step (shared fairly)
    max_in_flight: int = 64         # bounded queue; send() -> False when full


@dataclasses.dataclass
class FaultSpec:
    """Injectable faults for the unreliable message class."""
    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Message:
    src: str
    dst: str
    kind: str
    payload: Any
    size_bytes: int
    reliable: bool
    seq: int            # global send order (tie-break / debugging)
    sent_step: int
    credited: float = 0.0   # bytes serialized so far


class Transport:
    def __init__(self, default_link: LinkSpec | None = None,
                 faults: FaultSpec | None = None):
        self.default_link = default_link or LinkSpec()
        self.faults = faults or FaultSpec()
        self._rng = random.Random(self.faults.seed)
        self.now = 0
        self._seq = 0
        self._links: dict[tuple[str, str], LinkSpec] = {}
        self._queues: dict[tuple[str, str], deque[Message]] = {}
        self._handlers: dict[tuple[str, str], Callable[[Message, int], None]] = {}
        self._partitioned: set[tuple[str, str]] = set()
        self.counts = {"sent": 0, "delivered": 0, "dropped": 0,
                       "duplicated": 0, "reordered": 0, "rejected": 0}
        self.bytes_sent = 0
        self.bytes_delivered = 0
        self._m_msgs = None
        self._m_bytes = None
        self._g_inflight = None

    # -- topology ---------------------------------------------------------
    def set_link(self, src: str, dst: str, spec: LinkSpec,
                 symmetric: bool = False) -> None:
        self._links[(src, dst)] = spec
        if symmetric:
            self._links[(dst, src)] = spec

    def link(self, src: str, dst: str) -> LinkSpec:
        return self._links.get((src, dst), self.default_link)

    def register(self, node: str, kind: str,
                 handler: Callable[[Message, int], None]) -> None:
        """Bind the handler invoked as handler(msg, now) on delivery."""
        self._handlers[(node, kind)] = handler

    def partition(self, a: str, b: str) -> None:
        """Sever both directions between a and b (queued traffic stalls)."""
        self._partitioned.add((a, b))
        self._partitioned.add((b, a))

    def heal(self, a: str, b: str) -> None:
        self._partitioned.discard((a, b))
        self._partitioned.discard((b, a))

    def is_partitioned(self, src: str, dst: str) -> bool:
        return (src, dst) in self._partitioned

    # -- sending ----------------------------------------------------------
    def in_flight(self, src: str | None = None, dst: str | None = None) -> int:
        return sum(len(q) for (s, d), q in self._queues.items()
                   if (src is None or s == src) and (dst is None or d == dst))

    def send(self, src: str, dst: str, kind: str, payload: Any,
             size_bytes: int = 0, reliable: bool = True) -> bool:
        """Enqueue a message.  False = link queue full (backpressure): the
        caller must retry later.  True means *accepted*, not delivered —
        an unreliable message may still have been dropped in flight."""
        spec = self.link(src, dst)
        q = self._queues.setdefault((src, dst), deque())
        if len(q) >= spec.max_in_flight:
            self.counts["rejected"] += 1
            if self._m_msgs is not None:
                self._m_msgs.inc(kind=kind, outcome="rejected")
            return False
        self.counts["sent"] += 1
        self.bytes_sent += size_bytes
        if self._m_msgs is not None:
            self._m_msgs.inc(kind=kind, outcome="sent")
        if self._m_bytes is not None:
            self._m_bytes.inc(size_bytes, direction="sent")
        if not reliable and self._rng.random() < self.faults.drop:
            self.counts["dropped"] += 1
            if self._m_msgs is not None:
                self._m_msgs.inc(kind=kind, outcome="dropped")
            return True  # fire-and-forget: the sender cannot observe loss
        self._seq += 1
        msg = Message(src, dst, kind, payload, size_bytes, reliable,
                      self._seq, self.now)
        q.append(msg)
        if not reliable and self._rng.random() < self.faults.duplicate:
            self._seq += 1
            q.append(dataclasses.replace(msg, seq=self._seq))
            self.counts["duplicated"] += 1
            if self._m_msgs is not None:
                self._m_msgs.inc(kind=kind, outcome="duplicated")
        return True

    # -- clock ------------------------------------------------------------
    def _ready(self, m: Message, spec: LinkSpec) -> bool:
        return (self.now >= m.sent_step + spec.latency_steps
                and m.credited >= m.size_bytes)

    def step(self, n: int = 1) -> int:
        """Advance the transport clock n steps; returns messages delivered."""
        delivered = 0
        for _ in range(n):
            self.now += 1
            for key in list(self._queues):
                delivered += self._pump_link(key)
        if self._g_inflight is not None:
            self._g_inflight.set(self.in_flight())
        return delivered

    def _pump_link(self, key: tuple[str, str]) -> int:
        q = self._queues[key]
        if not q or self.is_partitioned(*key):
            return 0
        spec = self.link(*key)
        if math.isfinite(spec.bandwidth):
            share = spec.bandwidth / len(q)
            for m in q:
                m.credited += share
        else:
            for m in q:
                m.credited = m.size_bytes
        ready: list[Message] = []
        while q and self._ready(q[0], spec):
            ready.append(q.popleft())
        out = 0
        for i, m in enumerate(ready):
            # reorder fault: push a deliverable unreliable message behind
            # everything still queued — it overtakes nothing and is
            # overtaken by later traffic
            if (not m.reliable and len(ready) > 1
                    and self._rng.random() < self.faults.reorder):
                self.counts["reordered"] += 1
                q.append(m)
                continue
            self.counts["delivered"] += 1
            self.bytes_delivered += m.size_bytes
            if self._m_msgs is not None:
                self._m_msgs.inc(kind=m.kind, outcome="delivered")
            if self._m_bytes is not None:
                self._m_bytes.inc(m.size_bytes, direction="delivered")
            out += 1
            handler = self._handlers.get((m.dst, m.kind))
            if handler is not None:
                handler(m, self.now)
        return out

    def quiesce(self, max_steps: int = 10_000) -> int:
        """Step until every queue drains (partitions stall forever — heal
        first).  Returns steps taken."""
        steps = 0
        while self.in_flight() and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- observability ----------------------------------------------------
    def attach_metrics(self, registry) -> None:
        self._m_msgs = registry.counter(
            "transport_messages_total",
            "Transport messages by kind and outcome", ("kind", "outcome"))
        self._m_bytes = registry.counter(
            "transport_bytes_total",
            "Transport payload bytes", ("direction",))
        self._g_inflight = registry.gauge(
            "transport_in_flight", "Messages queued on all links")


class DirectoryTransportClient:
    """Replica-side cache-directory sink that publishes over the fabric.

    Duck-typed drop-in for :class:`ClusterCacheDirectory` wherever a
    replica holds a directory reference: ``on_insert``/``on_evict`` deltas
    and ``reconcile`` snapshots become *unreliable* messages (gossip-grade
    — the subset invariant tolerates loss because anti-entropy repeats),
    ``drop_replica`` is reliable (membership changes must land).  Every
    message carries a per-client monotone ``seq`` so the service can
    discard traffic that a newer reconcile snapshot already supersedes.
    """

    def __init__(self, transport: Transport, node: str,
                 directory_node: str = "ctrl", kind: str = "dir_delta"):
        self.transport = transport
        self.node = node
        self.directory_node = directory_node
        self.kind = kind
        self._seq = 0

    def _post(self, op: str, replica, reliable: bool = False,
              size_bytes: int = 64, **fields) -> None:
        self._seq += 1
        self.transport.send(
            self.node, self.directory_node, self.kind,
            {"op": op, "replica": replica, "seq": self._seq, **fields},
            size_bytes=size_bytes, reliable=reliable)

    # the PrefixCache sink surface
    def on_insert(self, replica, chain) -> None:
        self._post("insert", replica, chain=chain)

    def on_evict(self, replica, chain) -> None:
        self._post("evict", replica, chain=chain)

    # the engine attach/reconcile surface
    def reconcile(self, replica, chains) -> tuple[int, int]:
        chains = sorted(chains)
        self._post("reconcile", replica, chains=chains,
                   size_bytes=64 + 8 * len(chains))
        return (0, 0)  # applied remotely; deltas unknown at the sender

    def drop_replica(self, replica) -> int:
        self._post("drop", replica, reliable=True)
        return 0


class DirectoryTransportService:
    """Control-plane endpoint applying delivered directory messages.

    Reorder safety: a reconcile snapshot replaces the replica's claimed
    set wholesale, so any delta (or older reconcile) generated *before*
    that snapshot but delivered *after* it must be ignored — its effect is
    already inside (or superseded by) the snapshot.  The per-client
    monotone ``seq`` makes "before" checkable: track the highest applied
    reconcile seq per replica and drop anything at or below it.
    Duplicated deltas above the floor are harmless (set semantics).
    """

    def __init__(self, directory):
        self.directory = directory
        self._floor: dict[Any, int] = {}
        self.stale_ignored = 0

    def bind(self, transport: Transport, node: str,
             kind: str = "dir_delta") -> None:
        transport.register(node, kind, self.handle)

    def handle(self, msg: Message, now: int | None = None) -> None:
        p = msg.payload
        op, replica, seq = p["op"], p["replica"], p["seq"]
        if op == "drop":
            self.directory.drop_replica(replica)
            self._floor.pop(replica, None)
            return
        if op == "reconcile":
            if seq <= self._floor.get(replica, -1):
                self.stale_ignored += 1
                return
            self._floor[replica] = seq
            self.directory.reconcile(replica, set(p["chains"]))
            return
        if seq <= self._floor.get(replica, -1):
            self.stale_ignored += 1
            return
        if op == "insert":
            self.directory.on_insert(replica, p["chain"])
        elif op == "evict":
            self.directory.on_evict(replica, p["chain"])
