"""Cluster-level prefix-cache directory (ROADMAP: route-by-content).

PR 2 gave every paged replica its own block-level prefix cache; PR 3 made
migration donate transferred blocks into the destination's index.  Both
kept the *knowledge* of what is cached strictly per replica, so the load
balancer could only approximate locality by hashing the prompt's first
block ("prefix" policy).  This module lifts that knowledge to the cluster:

:class:`ClusterCacheDirectory` maps content-addressed **chain hashes**
(``serving/prefix_cache.py: chain_key`` — the radix path from the root,
folded block by block) to the set of replicas whose prefix index retains
that block.  Each replica's :class:`~repro_torch.serving.prefix_cache.PrefixCache`
publishes insert/evict deltas through a lightweight event sink
(``attach_sink``); migration donation and scale-down drain flow through the
same two events, so adopted blocks become routable the moment the
destination indexes them.

The directory is **advisory and deliberately staleness-tolerant**: routing
on a stale entry costs at most a missed locality win, never correctness —
the replica's own cache is always the source of truth at admission.  Two
mechanisms bound the drift:

* deltas keep the directory a *conservative subset* of what replicas
  retain (an entry is only added when a block is indexed and dropped when
  one with that chain is uncached);
* periodic **reconciliation** replaces a replica's claimed set with the
  chains its radix tree can actually serve (``reachable_chains``), which
  also repairs orphaned-descendant staleness and any lost events.

Routing consumes :meth:`overlaps`: a radix-style walk of the *whole*
prompt (not just its first block) that returns, per replica, how many
leading prompt tokens that replica could serve from cache.  The
``"directory"`` load-balancer policy blends this with load slack.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.serving.prefix_cache import chain_walk


@dataclasses.dataclass
class DirectoryStats:
    """Cumulative event/consistency telemetry (control-plane visible)."""
    inserts: int = 0
    evicts: int = 0
    reconciles: int = 0
    stale_dropped: int = 0     # reconcile removed entries deltas had missed
    missed_added: int = 0      # reconcile added entries deltas had missed
    lookups: int = 0
    lookup_hit_tokens: int = 0  # best-replica overlap summed over lookups


class ClusterCacheDirectory:
    """block-chain -> replica-set index over every replica's prefix cache."""

    def __init__(self, max_intents_per_replica: int = 1024):
        self._chains: dict[int, set[int]] = {}    # chain -> replica ids
        self._replicas: dict[int, set[int]] = {}  # replica id -> chains
        # routing intents: chains a router just sent toward a replica, not
        # yet committed by that replica's index (the request is still in
        # flight).  Kept separate so the committed view stays a conservative
        # subset of replica state; merged into lookups so a burst of
        # same-prefix requests co-locates before the first one retires.
        # An intent dies when the chain commits (on_insert) or proves wrong
        # (on_evict), when its replica reconciles or departs, or — so a
        # reconcile-free configuration cannot grow without bound — when the
        # per-replica FIFO cap evicts it.
        self.max_intents_per_replica = max_intents_per_replica
        self._intent_chains: dict[int, set[int]] = {}   # chain -> replicas
        # replica -> chains in announce order (dict = insertion-ordered FIFO)
        self._intent_replicas: dict[int, dict[int, None]] = {}
        self.stats = DirectoryStats()

    # ---------------------------------------------------------- event sink
    def on_insert(self, replica: int, chain: int) -> None:
        self._chains.setdefault(chain, set()).add(replica)
        self._replicas.setdefault(replica, set()).add(chain)
        self._drop_intent(replica, chain)      # the optimism came true
        self.stats.inserts += 1

    def on_evict(self, replica: int, chain: int) -> None:
        self._discard(replica, chain)
        self._drop_intent(replica, chain)
        self.stats.evicts += 1

    def _discard(self, replica: int, chain: int) -> None:
        holders = self._chains.get(chain)
        if holders is not None:
            holders.discard(replica)
            if not holders:
                del self._chains[chain]
        claimed = self._replicas.get(replica)
        if claimed is not None:
            claimed.discard(chain)

    # -------------------------------------------------------------- intents
    def announce(self, replica: int, tokens: Sequence[int],
                 block_size: int) -> None:
        """Routing intent: ``tokens`` was just routed to ``replica``, whose
        cache will hold the prompt's full blocks once the request retires.
        Same-prefix requests arriving before then co-locate instead of
        scattering by load.  Intents are advisory-on-advisory: they never
        touch the committed view, and the next reconcile (or scale-down)
        of the replica clears them — by then the real insert events have
        either committed the chains or the optimism was wrong."""
        mine = self._intent_replicas.setdefault(replica, {})
        for chain in chain_walk(tokens, block_size):
            if chain not in self._replicas.get(replica, ()):
                self._intent_chains.setdefault(chain, set()).add(replica)
                mine[chain] = None
        while len(mine) > self.max_intents_per_replica:   # FIFO bound
            self._drop_intent(replica, next(iter(mine)))

    def _drop_intent(self, replica: int, chain: int) -> None:
        mine = self._intent_replicas.get(replica)
        if mine is not None:
            mine.pop(chain, None)
        holders = self._intent_chains.get(chain)
        if holders is not None:
            holders.discard(replica)
            if not holders:
                del self._intent_chains[chain]

    def _clear_intents(self, replica: int) -> None:
        for c in list(self._intent_replicas.get(replica, ())):
            self._drop_intent(replica, c)
        self._intent_replicas.pop(replica, None)

    # ------------------------------------------------------- reconciliation
    def reconcile(self, replica: int, chains: set[int]) -> tuple[int, int]:
        """Replace ``replica``'s claimed set with the chains its cache can
        actually serve right now.  Returns ``(dropped, added)`` — the
        entries the delta stream had missed in either direction (lost
        events, orphaned radix descendants)."""
        self._clear_intents(replica)
        claimed = self._replicas.get(replica, set())
        stale = claimed - chains
        missing = chains - claimed
        for c in stale:
            self._discard(replica, c)
        for c in missing:
            self._chains.setdefault(c, set()).add(replica)
        self._replicas[replica] = set(chains)
        self.stats.reconciles += 1
        self.stats.stale_dropped += len(stale)
        self.stats.missed_added += len(missing)
        return len(stale), len(missing)

    def drop_replica(self, replica: int) -> int:
        """Scale-down invalidation: forget everything a departing replica
        claimed (its pool is gone with it).  Returns entries removed."""
        self._clear_intents(replica)
        claimed = self._replicas.pop(replica, set())
        for c in claimed:
            holders = self._chains.get(c)
            if holders is not None:
                holders.discard(replica)
                if not holders:
                    del self._chains[c]
        return len(claimed)

    # --------------------------------------------------------------- lookup
    def overlaps(self, tokens: Sequence[int], block_size: int) -> dict[int, int]:
        """Expected cached-token overlap of ``tokens`` per replica: the
        cluster-level radix walk the ROADMAP asks for.  For each replica the
        value is the longest run of *consecutive-from-root* full blocks it
        claims, in tokens — consecutive because ``PrefixCache.match`` can
        only extend an unbroken prefix.  Capped at ``len(tokens) - 1``
        (mirroring ``PrefixCache.lookup``: the last prompt token is always
        recomputed for first-token logits)."""
        out: dict[int, int] = {}
        n = 0
        for chain in chain_walk(tokens, block_size):
            holders = self._chains.get(chain, set())
            intents = self._intent_chains.get(chain, ())
            if not holders and not intents:
                break
            extended = False
            for r in (*holders, *intents):
                if out.get(r, 0) == n:         # unbroken run from the root
                    out[r] = n + block_size
                    extended = True
            if not extended:
                break
            n += block_size
        self.stats.lookups += 1
        self.stats.lookup_hit_tokens += max(out.values(), default=0)
        return out

    def overlap(self, replica: int, tokens: Sequence[int],
                block_size: int) -> int:
        return self.overlaps(tokens, block_size).get(replica, 0)

    # ------------------------------------------------------------ telemetry
    @property
    def total_entries(self) -> int:
        """(replica, chain) claims currently held."""
        return sum(len(v) for v in self._replicas.values())

    @property
    def distinct_chains(self) -> int:
        return len(self._chains)

    def replicas(self) -> set[int]:
        return {r for r, c in self._replicas.items() if c}

    def claimed(self, replica: int) -> set[int]:
        """The chains ``replica`` currently claims (copy)."""
        return set(self._replicas.get(replica, ()))
