"""Block-level prefix caching over a paged KV pool.

:class:`PrefixCache` owns every block of the paged KV pool and layers three
mechanisms on top of a plain free list:

* **Ref-counted sharing** — a block may back several live sequences at once
  (all of them read the same prompt-prefix KV).  A block returns to the free
  list only when its refcount reaches zero *and* it is not retained by the
  cache index.
* **Radix/trie prefix index** — full blocks form a radix tree whose edges
  are ``(parent node, the block's own tokens)``, plus one partially-filled
  *tail* block per node.  ``match`` walks edge-by-edge (each prompt token
  hashed once, O(L)) and returns the longest cached prefix of a new
  prompt; those tokens never get prefilled again.
* **LRU eviction + copy-on-write** — unreferenced cached blocks sit in an
  LRU; allocation reclaims them oldest-first, so the cache can use the whole
  idle pool without ever blocking live traffic.  Matching a partial tail
  hands a sequence a block it must not write (the cache — and possibly other
  sequences — still read it); ``needs_cow`` tells the engine to copy it into
  a private block before the first append.

The engine charges KV memory per block through this class (``used_blocks`` /
``utilization``), which is what the control plane's autoscaler and balancer
consume instead of the dense per-row worst case.

A cluster cache directory (``core/cache_directory.py``) can subscribe to
index mutations through :meth:`PrefixCache.attach_sink`: every full block
indexed or dropped is published as a content-addressed **chain hash** —
``chain_key`` folded block-by-block from the radix root — so replicas with
different local block ids and node ids still report the same key for the
same cached token prefix.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Sequence


Key = tuple[int, ...]

#: chain hash of the radix root (the empty prefix)
ROOT_CHAIN = 0


def chain_key(parent_chain: int, tokens: Key) -> int:
    """Content address of a full cached block: hash of the parent prefix's
    chain and the block's own tokens.  Replica-independent — two caches
    holding the same token prefix report the same chain — which is what
    lets a cluster directory aggregate per-replica radix trees."""
    h = hashlib.blake2b(f"{parent_chain}/{tokens!r}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def chain_walk(tokens: Sequence[int], block_size: int,
               limit: int | None = None) -> list[int]:
    """Chain hashes of every consecutive-from-root full block of ``tokens``,
    in prefix order.  ``limit`` defaults to ``len(tokens) - 1``, mirroring
    ``PrefixCache.lookup`` (the last prompt token is always recomputed for
    first-token logits).  The shared walk under directory ``announce``/
    ``overlaps`` and the transport property tests."""
    if limit is None:
        limit = len(tokens) - 1
    out: list[int] = []
    chain = ROOT_CHAIN
    n = 0
    while n + block_size <= limit:
        chain = chain_key(chain, tuple(tokens[n:n + block_size]))
        out.append(chain)
        n += block_size
    return out


@dataclasses.dataclass
class CachedBlock:
    block: int
    parent: int              # radix node the block extends (0 = root)
    tokens: Key              # tokens stored in the block (len == bs if full)
    node: int | None         # this block's radix node id; None for tails
    chain: int | None = None  # content chain hash (full blocks only)


class PrefixCache:
    """Ref-counted block allocator with a block-granularity prefix index."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict[int, int] = {}
        # radix index over full blocks: edges are (parent node, block tokens)
        # so a lookup hashes each token once, O(L) per walk — never the whole
        # growing prefix per step.  One partial tail may hang off any node.
        self._full: dict[tuple[int, Key], CachedBlock] = {}
        self._tail: dict[int, CachedBlock] = {}    # node -> partial tail
        self._entry: dict[int, CachedBlock] = {}   # cached block -> entry
        self._next_node = 1                        # 0 is the root
        self._lru: OrderedDict[int, None] = OrderedDict()  # ref==0 & cached
        # telemetry (token-granularity, cumulative)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0
        self.cow_copies = 0
        self.inserted_blocks = 0
        # bumped whenever the index mutates; lets callers memoise lookups
        self.generation = 0
        # optional cluster-directory event sink (attach_sink): receives
        # on_insert/on_evict deltas for every full block this index retains
        self._sink = None
        self.replica_id: int | None = None

    # ------------------------------------------------------- directory sink
    def attach_sink(self, sink, replica_id: int) -> None:
        """Publish index deltas to a cluster cache directory.  ``sink``
        needs ``on_insert(replica_id, chain)`` and
        ``on_evict(replica_id, chain)``; the current index is pushed via
        :meth:`reachable_chains` + ``sink.reconcile`` by the caller."""
        self._sink = sink
        self.replica_id = replica_id

    def detach_sink(self) -> None:
        self._sink = None

    def _publish(self, event: str, chain: int | None) -> None:
        if self._sink is None or chain is None:
            return
        if event == "insert":
            self._sink.on_insert(self.replica_id, chain)
        else:
            self._sink.on_evict(self.replica_id, chain)

    def reachable_chains(self) -> set[int]:
        """Chain hashes of every full block reachable from the radix root —
        the prefixes :meth:`match` can actually serve.  Orphaned descendants
        of an evicted parent still hold pool blocks (``_entry``) but are
        excluded: a directory reconciled against this set never routes a
        prompt to an unservable prefix."""
        children: dict[int, list[CachedBlock]] = {}
        for e in self._full.values():
            children.setdefault(e.parent, []).append(e)
        out: set[int] = set()
        stack = [0]
        while stack:
            node = stack.pop()
            for e in children.get(node, ()):
                if e.chain is not None:
                    out.add(e.chain)
                stack.append(e.node)
        return out

    # ------------------------------------------------------------- refcounts
    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def incref(self, block: int) -> None:
        n = self._ref.get(block, 0)
        if n == 0 and block in self._lru:      # referenced again: not evictable
            del self._lru[block]
        self._ref[block] = n + 1

    def decref(self, block: int) -> None:
        n = self._ref.get(block, 0)
        if n <= 0:
            raise ValueError(f"decref of unreferenced block {block}")
        n -= 1
        self._ref[block] = n
        if n == 0:
            del self._ref[block]
            if block in self._entry:           # retained by the cache: evictable
                self._lru[block] = None
            else:
                self._free.append(block)

    # ------------------------------------------------------------ allocation
    def allocate(self, n: int = 1) -> list[int] | None:
        """n fresh blocks (refcount 1 each), evicting LRU cached blocks if the
        free list runs dry.  None if even eviction cannot cover the request —
        every block is referenced by a live sequence."""
        if len(self._free) + len(self._lru) < n:
            return None
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            b = self._free.pop()
            self._ref[b] = 1
            out.append(b)
        return out

    def _evict_one(self) -> None:
        block, _ = self._lru.popitem(last=False)   # oldest first
        self._uncache(block)
        self._free.append(block)
        self.evictions += 1
        self.generation += 1

    def _uncache(self, block: int) -> None:
        e = self._entry.pop(block)
        if e.node is not None:
            if self._full.get((e.parent, e.tokens)) is e:
                del self._full[(e.parent, e.tokens)]
            # descendants keyed under e.node become unreachable; they stay
            # refcounted/LRU-tracked and age out through normal eviction —
            # the directory keeps their chains until reconciliation, which
            # is the staleness the directory contract tolerates
            self._publish("evict", e.chain)
        elif self._tail.get(e.parent) is e:
            del self._tail[e.parent]

    # ---------------------------------------------------------------- lookup
    def lookup(self, tokens: list[int]) -> int:
        """Longest cached prefix length, in tokens, without taking refs.
        Capped at len(tokens)-1: the last prompt token must always be
        prefilled to produce first-token logits."""
        return self._walk(tokens)[1]

    def _walk(self, tokens: list[int]) -> tuple[list[int], int]:
        bs = self.block_size
        limit = len(tokens) - 1
        blocks: list[int] = []
        n, node = 0, 0
        while n + bs <= limit:
            e = self._full.get((node, tuple(tokens[n : n + bs])))
            if e is None:
                break
            blocks.append(e.block)
            node = e.node
            n += bs
        t = self._tail.get(node)
        if t is not None and 0 < len(t.tokens) <= limit - n and \
                tuple(tokens[n : n + len(t.tokens)]) == t.tokens:
            blocks.append(t.block)
            n += len(t.tokens)
        return blocks, n

    def match(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached prefix of ``tokens``: (blocks, n_tokens).  Each
        returned block is increfed (the caller owns one reference) and
        touched in the LRU.  The last block may be a partial tail — the
        caller must CoW it before writing (``needs_cow``)."""
        blocks, n = self._walk(tokens)
        for b in blocks:
            # incref pulls the block out of the LRU; recency is re-stamped
            # when the final decref re-appends it
            self.incref(b)
        self.hit_tokens += n
        self.miss_tokens += max(len(tokens) - n, 0)
        return blocks, n

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: list[int], blocks: list[int], n_valid: int) -> int:
        """Index a retiring sequence's blocks under its token prefix.

        ``tokens``: the sequence's tokens whose KV is materialised (prompt +
        generated-minus-last); ``blocks``: its block table; ``n_valid``: how
        many leading tokens of ``tokens`` have KV written.  Blocks already
        indexed (same key) are skipped — dedup keeps one block per prefix.
        Returns the number of newly indexed blocks.  Does NOT change
        refcounts: the caller still holds its per-sequence references and
        releases them afterwards; cache retention is orthogonal to refs.
        """
        bs = self.block_size
        n_valid = min(n_valid, len(tokens), len(blocks) * bs)
        added = 0
        nfull = n_valid // bs
        node, chain_ok = 0, True
        chain = ROOT_CHAIN
        for i in range(nfull):
            btoks = tuple(tokens[i * bs : (i + 1) * bs])
            chain = chain_key(chain, btoks)
            e = self._full.get((node, btoks))
            if e is not None:                  # path already indexed: descend
                node = e.node
                continue
            b = blocks[i]
            if b in self._entry:               # indexed under another path —
                chain_ok = False               # deeper nodes would be orphans
                break
            e = CachedBlock(b, node, btoks, node=self._next_node, chain=chain)
            self._next_node += 1
            self._full[(node, btoks)] = e
            self._entry[b] = e
            self._publish("insert", chain)
            added += 1
            node = e.node
        # partial tail
        rem = n_valid - nfull * bs
        if chain_ok and rem > 0 and nfull < len(blocks):
            btoks = tuple(tokens[nfull * bs : n_valid])
            cur = self._tail.get(node)
            b = blocks[nfull]
            if (cur is None or len(cur.tokens) < len(btoks)) and b not in self._entry:
                if cur is not None:
                    self._drop_entry(cur.block)
                e = CachedBlock(b, node, btoks, node=None)
                self._tail[node] = e
                self._entry[b] = e
                added += 1
        self.inserted_blocks += added
        if added:
            self.generation += 1
        return added

    def _drop_entry(self, block: int) -> None:
        """Remove a block from the index; free it if unreferenced."""
        self._uncache(block)
        self.generation += 1
        if block in self._lru:
            del self._lru[block]
            self._free.append(block)

    # ------------------------------------------------------------------ misc
    def needs_cow(self, block: int) -> bool:
        """True if writing this block would corrupt another reader: it is
        shared by other sequences or retained by the cache index."""
        return self.ref(block) > 1 or block in self._entry

    def release(self, blocks: list[int]) -> None:
        for b in blocks:
            self.decref(b)

    # ------------------------------------------------------------- telemetry
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by live sequences."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Blocks retained by the prefix index (referenced or evictable)."""
        return len(self._entry)

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    def utilization(self) -> float:
        """Fraction of the pool holding live (referenced) blocks."""
        return self.used_blocks / max(self.num_blocks, 1)

    def hit_rate(self) -> float:
        seen = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / seen if seen else 0.0

    def adopt_blocks(self, seq: list[int], n_valid: int,
                     extra_horizon: int = 0,
                     reserved: int = 0) -> tuple[list[int], int] | None:
        """Destination-side block plan for a migrated sequence whose KV
        covers positions ``[0, n_valid)``.

        Full blocks whose token content this cache already indexes are
        *reused* (read-shared, never re-transferred); the rest are freshly
        allocated for the sender's payload to land in.  Admission is
        reservation-aware: the plan is refused — with the speculative match
        fully rolled back, so a refused adopt leaves the cache untouched —
        unless the fresh blocks *plus* ``extra_horizon`` (blocks the adopted
        request may still grow into) fit what live rows have not already
        reserved (``reserved``).  Hit/miss telemetry is neutralised: a
        migration is a transfer, not a served prompt.

        Returns ``(blocks, n_keep)`` — the full position-aligned block list
        (blocks[:n_keep] reused, blocks[n_keep:] fresh, refcount held on
        all) — or ``None`` when the pool cannot admit the request.
        """
        bs = self.block_size
        n_total = -(-n_valid // bs)
        hit_blocks: list[int] = []
        n_hit = 0
        if seq:
            hit_blocks, n_hit = self.match(seq)
            # neutralise the counters match() bumped
            self.hit_tokens -= n_hit
            self.miss_tokens -= max(len(seq) - n_hit, 0)
            if n_hit % bs:
                # only aligned full blocks can stand in for transferred
                # ones — a partial tail is dropped, not fast-forwarded
                self.decref(hit_blocks.pop())
                n_hit -= n_hit % bs
        n_keep = min(n_hit // bs, len(hit_blocks))
        del hit_blocks[n_keep:]
        fresh_needed = n_total - n_keep
        if (fresh_needed + extra_horizon
                > self.free_blocks + self.evictable_blocks - reserved):
            self.release(hit_blocks)
            return None
        fresh = self.allocate(fresh_needed) if fresh_needed else []
        if fresh is None:                      # unreachable given the check
            self.release(hit_blocks)
            return None
        return hit_blocks + fresh, n_keep

    def check_invariants(self) -> None:
        """Structural audit used by the property tests."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for b in free:
            assert self.ref(b) == 0 and b not in self._entry and b not in self._lru
        for b, n in self._ref.items():
            assert n > 0, f"non-positive refcount {n} for block {b}"
            assert b not in free and b not in self._lru
        for b in self._lru:
            assert self.ref(b) == 0 and b in self._entry
        for (pid, btoks), e in self._full.items():
            assert self._entry.get(e.block) is e
            assert e.parent == pid and e.tokens == btoks and e.node is not None
            assert e.chain is not None, "full block missing its chain hash"
        for pid, e in self._tail.items():
            assert self._entry.get(e.block) is e
            assert e.parent == pid and e.node is None and e.chain is None
        tracked = len(free) + len(self._ref) + len(self._lru)
        assert tracked == self.num_blocks, (tracked, self.num_blocks)
