"""KV-cache management for serving.

* :class:`RowPool` — fixed-slot continuous-batching pool: each active request
  owns one row of the (B, L, KV, hd) per-layer caches.
* :class:`PagedAllocator` — the minimal non-shared block allocator (the
  PagedAttention control structure).  The engine's paged backend allocates
  through ``serving/prefix_cache.PrefixCache``, its ref-counted superset.
* ``paged_write`` / ``paged_write_chunk`` / ``paged_gather`` — tensor ops on
  (num_blocks, block_size, KV, hd) pools.  The writers update the pools in
  place; a write that the reference drops (``.at[].set(mode="drop")`` on an
  out-of-bounds block) is masked out here and never lands anywhere.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


# --------------------------------------------------------------------- rows
class RowPool:
    """Free-list of batch rows in a fixed decode batch."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._free = list(range(capacity - 1, -1, -1))
        self.owner: dict[int, int] = {}          # row -> rid

    def allocate(self, rid: int) -> int | None:
        if not self._free:
            return None
        row = self._free.pop()
        self.owner[row] = rid
        return row

    def free(self, row: int) -> None:
        assert row in self.owner, f"double free of row {row}"
        del self.owner[row]
        self._free.append(row)

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def utilization(self) -> float:
        return self.used / max(self.capacity, 1)


# -------------------------------------------------------------------- paged
@dataclasses.dataclass
class SeqAlloc:
    blocks: list[int]
    length: int


class PagedAllocator:
    """Host-side block allocator (the PagedAttention control structure)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))
        self.seqs: dict[int, SeqAlloc] = {}

    def _need(self, length: int) -> int:
        return -(-length // self.block_size)

    def allocate(self, rid: int, length: int) -> list[int] | None:
        n = self._need(max(length, 1))
        if len(self._free) < n or rid in self.seqs:
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self.seqs[rid] = SeqAlloc(blocks, length)
        return blocks

    def extend(self, rid: int, new_length: int) -> list[int] | None:
        """Grow a sequence; returns newly added blocks (may be empty), or
        None if out of memory."""
        if rid not in self.seqs:
            raise ValueError(f"extend of unknown rid {rid}: allocate() it "
                             f"first (live rids: {sorted(self.seqs)})")
        a = self.seqs[rid]
        need = max(self._need(new_length) - len(a.blocks), 0)
        if len(self._free) < need:
            return None
        new = [self._free.pop() for _ in range(need)]
        a.blocks.extend(new)
        a.length = new_length
        return new

    def free(self, rid: int) -> None:
        a = self.seqs.pop(rid)
        self._free.extend(a.blocks)

    def blocks_used(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self) -> float:
        return self.blocks_used() / max(self.num_blocks, 1)

    def internal_fragmentation(self) -> float:
        """Wasted tail-of-block slots / allocated slots."""
        alloc = sum(len(a.blocks) for a in self.seqs.values()) * self.block_size
        live = sum(a.length for a in self.seqs.values())
        return 0.0 if alloc == 0 else 1.0 - live / alloc

    def block_table(self, rid: int, max_blocks: int) -> np.ndarray:
        t = np.full((max_blocks,), -1, np.int32)
        b = self.seqs[rid].blocks[:max_blocks]
        t[: len(b)] = b
        return t


def _slots(block_table, pos, ok, bs: int):
    """Flat indices of the writes that land, with their blocks and offsets.

    pos, ok: (B, C).  A write lands when ``ok`` holds and the table maps a
    block at ``pos``.  Selecting the kept entries costs one device sync, so
    a forward pass computes its slots once and reuses them in every layer."""
    max_blk = block_table.shape[1]
    blk = block_table.gather(1, (pos // bs).clamp(0, max_blk - 1))
    ok = ok & (blk >= 0) & (pos // bs < max_blk)
    sel = ok.reshape(-1).nonzero()[:, 0]
    return sel, blk.reshape(-1)[sel].long(), (pos % bs).reshape(-1)[sel]


def paged_write_slots(block_table, pos, block_size: int, live=None):
    """Slots of a one-token-per-row write (``paged_write``)."""
    pos = pos.long()[:, None]
    ok = torch.ones_like(pos, dtype=torch.bool) if live is None else live[:, None]
    return _slots(block_table, pos, ok, block_size)


def paged_write_chunk_slots(block_table, pos0, n_valid, chunk: int, block_size: int):
    """Slots of a chunk write (``paged_write_chunk``)."""
    ar = torch.arange(chunk, device=pos0.device)[None, :]
    return _slots(block_table, pos0.long()[:, None] + ar, ar < n_valid[:, None],
                  block_size)


def _scatter(k_pool, v_pool, slots, k_new, v_new):
    sel, blk, off = slots
    k_pool[blk, off] = k_new.reshape(-1, *k_new.shape[-2:])[sel].to(k_pool.dtype)
    v_pool[blk, off] = v_new.reshape(-1, *v_new.shape[-2:])[sel].to(v_pool.dtype)


def paged_write(k_pool, v_pool, block_table, pos, k_new, v_new, live=None, *,
                slots=None):
    """Write one token per row, in place.  k/v_new (B, KV, hd).  Rows whose
    table slot is -1 (no block mapped at ``pos``) or whose ``live`` flag is
    False write nothing — never clamped into block 0, which belongs to some
    other sequence.  ``slots``: precomputed ``paged_write_slots``."""
    if slots is None:
        slots = paged_write_slots(block_table, pos, k_pool.shape[1], live)
    _scatter(k_pool, v_pool, slots, k_new, v_new)
    return k_pool, v_pool


def paged_write_chunk(k_pool, v_pool, block_table, pos0, n_valid, k_new, v_new, *,
                      slots=None):
    """Append a chunk of C tokens per row at positions pos0 .. pos0+n_valid-1
    through the block table, in place.  k/v_new (B, C, KV, hd).  Rows with
    n_valid == 0 and pad positions write nothing.  ``slots``: precomputed
    ``paged_write_chunk_slots``."""
    if slots is None:
        slots = paged_write_chunk_slots(block_table, pos0, n_valid,
                                        k_new.shape[1], k_pool.shape[1])
    _scatter(k_pool, v_pool, slots, k_new, v_new)
    return k_pool, v_pool


def paged_gather(pool, block_table, max_len: int):
    """(B, max_len, KV, hd) contiguous copy gathered through block tables.

    The block count is rounded up and the ragged tail kept; slots of
    unmapped blocks (table == -1) are zero rather than aliasing block 0."""
    B, max_blk = block_table.shape
    bs = pool.shape[1]
    n_blk = min(-(-max_len // bs), max_blk)
    tbl = block_table[:, :n_blk]                                      # (B, n_blk)
    gathered = pool[tbl.long().clamp(min=0)]                          # (B, n_blk, bs, ...)
    mask = (tbl >= 0).reshape(B, n_blk, *([1] * (pool.ndim - 1)))
    gathered = torch.where(mask, gathered, torch.zeros((), dtype=pool.dtype,
                                                       device=pool.device))
    out = gathered.reshape(B, n_blk * bs, *pool.shape[2:])
    return out[:, :max_len]
