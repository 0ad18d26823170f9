"""Continuous-batching inference engine (Orca-style iteration scheduling).

One engine = one model replica on one device.  A fixed decode batch of
``capacity`` rows over a ``RowPool``, prefill bucketed to a few lengths,
per-row sampling parameter vectors.

Prefill is a pipeline:

* requests admitted in the same step are grouped by bucket and prefilled
  as one batched forward per bucket;
* prompts longer than the largest bucket are **chunked**: bucket-sized
  slices append into the row's KV cache across steps, so per-step prefill
  work stays bounded (``SchedulerConfig.prefill_token_budget``).  One chunk
  call covers the whole pool — idle rows ride along and are left untouched.

Two KV backends: ``dense`` (one cache row per request, the default: a
(max_len, KV, hd) KV row per global attention layer, a ring of the window
with its slot positions per windowed layer, the recurrent state per SSM
layer, an encoder-decoder's self-KV and cross-KV per decoder layer) and ``paged`` (block pools with a prefix cache, copy-on-write of
shared tails; global-attention decoders only, other models run dense).
Caches are preallocated tensors updated in place; every cache write a row
must not take (pad positions, rows that are not live, unmapped blocks) is
masked.  Each ``step()`` emits typed per-request events
and a ``StepStats`` record, which the front end (``serving/api.py``) and
the observability layer (``core/``) consume.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving.events import (EngineEvent, FinishEvent, FirstTokenEvent,
                                        PreemptEvent, TokenEvent)
from repro_torch.serving.kv_cache import RowPool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request, State
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, deadline_risk


def _round_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class StepStats:
    t: float
    decode_s: float
    prefill_s: float
    n_prefill: int
    occupancy: int
    queue_depth: int
    tokens_out: int
    prefill_tokens: int = 0     # prompt tokens prefilled this step (all paths)
    chunk_rows: int = 0         # rows advanced by the chunked-prefill call
    # what the step computed (bucket round-up / chunk slice width on dense;
    # the paged chunk call masks rather than pads, so there padded == true)
    prefill_tokens_padded: int = 0
    prefill_tokens_true: int = 0
    # paged-KV / prefix-cache telemetry (zero on the dense backend)
    prefix_hit_tokens: int = 0      # prompt tokens skipped at admission
    prefix_hit_rate: float = 0.0    # cumulative token hit rate
    kv_blocks_used: int = 0         # blocks referenced by live rows
    kv_blocks_cached: int = 0       # blocks retained by the prefix index
    kv_util: float = 0.0            # live-block (paged) / row (dense) fraction
    kv_frag: float = 0.0            # wasted tail-of-block slots / allocated
    events: list[EngineEvent] = dataclasses.field(default_factory=list)
    preempted: int = 0              # rows displaced by the SLO guard this step


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params=None, *,
                 capacity: int = 8, max_len: int = 128,
                 perf: PerfConfig = BASELINE,
                 sched: SchedulerConfig = SchedulerConfig(),
                 buckets: tuple[int, ...] = (16, 32, 64),
                 kv_backend: str = "dense",
                 block_size: int = 16, num_blocks: int | None = None,
                 enable_prefix_cache: bool = True,
                 seed: int = 0, tracer=None, metrics=None, device=None):
        assert kv_backend in ("dense", "paged")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.perf = perf
        self.model = make_model(cfg, perf)
        self.capacity = capacity
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        self.chunk = self.buckets[-1]       # chunked-prefill slice length
        # chunked prefill appends at text positions: a vision prefix (or an
        # encoder) keeps its requests bucketed
        self._can_chunk = not (cfg.is_encoder_decoder or cfg.num_vision_tokens)
        self.paged = kv_backend == "paged" and self.model.supports_paged()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = P.init(gen, self.model.param_specs(), self.device)
        self.params = params
        self.scheduler = Scheduler(sched)
        self.pool = RowPool(capacity)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        # device state: preallocated, updated in place --------------------
        # the dense layout's per-leaf batch axis, KV sequence axis and its
        # length (None: per-row state such as SSM, with no block form) —
        # row copies, resets, migration payloads and cross-backend payload
        # conversion all pivot on them, on either backend
        specs = self.model.cache_specs(capacity, max_len)
        self._batch_axes = P.tree_map(lambda sp: sp.axes.index("batch"), specs)
        # the fill of an empty row (ring slot positions hold -1)
        self._reset_vals = P.tree_map(
            lambda sp: sp.scale if sp.init == "const" else 0, specs)
        self._seq_axes = P.tree_map(
            lambda sp: sp.axes.index("act_kv") if "act_kv" in sp.axes else None,
            specs)
        self._seq_lens = P.tree_map(
            lambda sp: sp.shape[sp.axes.index("act_kv")]
            if "act_kv" in sp.axes else None, specs)
        if self.paged:
            self.block_size = block_size
            self.max_blk = -(-max_len // block_size)
            # default pool = the dense backend's worst-case footprint
            self.num_blocks = (capacity * self.max_blk if num_blocks is None
                               else num_blocks)
            self.prefix = PrefixCache(self.num_blocks, block_size)
            self.prefix_enabled = enable_prefix_cache
            paged_specs = self.model.paged_cache_specs(self.num_blocks,
                                                       block_size)
            self._pool_block_axes = P.tree_map(
                lambda sp: sp.axes.index("kv_blocks"), paged_specs)
            self.caches = P.init(None, paged_specs, self.device)
            self.block_tables = np.full((capacity, self.max_blk), -1, np.int32)
            self._row_blocks: dict[int, list[int]] = {}
            self._row_reserved: dict[int, int] = {}
            self._reserved_total = 0
            self._hit_tokens_step = 0
        else:
            # the dense pool keeps its spec dtype (bf16) whatever
            # perf.kv_dtype says, as the reference does
            self.caches = P.init(None, specs, self.device)
        self.tokens = np.zeros((capacity, 1), np.int64)
        self.pos = np.zeros((capacity,), np.int64)

        # host-side per-row bookkeeping --------------------------------------
        self.row_req: dict[int, Request] = {}
        self._temp = np.zeros((capacity,), np.float32)
        self._topk = np.zeros((capacity,), np.int64)
        self._topp = np.ones((capacity,), np.float32)
        # chunked-prefill rows: admission order preserved by dict insertion
        self._prefilling: dict[int, Request] = {}
        self._consumed: dict[int, int] = {}
        self._fresh: set[int] = set()
        self.rejected_long = 0
        # in-progress async adoptions (ticket -> reservation state): rows
        # whose KV is still streaming in over the transport, invisible to
        # stepping and migration until commit_adopt activates them
        self._pending_adopt: dict[int, dict] = {}
        self._next_ticket = 0

        self.history: list[StepStats] = []
        self.finished: list[Request] = []
        # event stream (serving/events.py), drained into StepStats.events
        self._pending_events: list[EngineEvent] = []
        self._risk_streak = 0       # consecutive SLO-guard-risky steps
        self.preemptions = 0        # rows displaced by the SLO guard (total)

        # observability (core/tracing.py, core/metrics.py) — imported at
        # run time: core/__init__ imports this module, so a module-level
        # import here would be circular.  The orchestrator and the
        # disaggregated server rebind every replica to shared ones via
        # set_tracer/set_metrics.
        from repro_torch.core.metrics import MetricsRegistry
        from repro_torch.core.tracing import Tracer
        self._rlabel = str(getattr(self, "replica_label", getattr(self, "lb_id", 0)))
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics: Any = None
        self._bind_instruments(metrics if metrics is not None
                               else MetricsRegistry())
        self.scheduler.on_reject = self._trace_reject

    # ------------------------------------------------------------- internals
    def _t(self, a) -> torch.Tensor:
        """Host array -> tensor on the engine's device."""
        return torch.as_tensor(a, device=self.device)

    def _sample(self, logits, temp, topk, topp, clock=None,
                part: str = "decode") -> np.ndarray:
        """Launch the sampler, then wait for its tokens on the host
        (``.cpu()``).  Within a step (``clock``) the launch is phase
        ``engine.<part>.sample``, its device time ending at the launch's
        end; a decode step's wait is ``engine.decode.wait`` and a chunk
        call's stays in its sample phase."""
        if clock is not None:
            clock.enter(f"engine.{part}.sample", device=True)
        out = sample(logits.float(), self.generator, self._t(temp),
                     self._t(topk), self._t(topp))
        if clock is not None:
            if part == "decode":
                clock.enter("engine.decode.wait")
            else:
                clock.end_device()
        return out.cpu().numpy()

    @torch.no_grad()
    def _insert_rows(self, new_caches, rows: list[int]) -> None:
        """Copy a batched prefill's caches into the pool rows, every leaf
        along its batch axis."""
        idx = self._t(np.asarray(rows, np.int64))
        for t, new, ax in P.tree_zip(self.caches, new_caches, self._batch_axes):
            t.index_copy_(ax, idx, new.to(t.dtype))

    @torch.no_grad()
    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one KV block across every layer pool (copy-on-write)."""
        for pool in self.caches:
            for n in ("k", "v"):
                pool[n][dst] = pool[n][src]

    # -------------------------------------------------- paged block plumbing
    def _blocks_horizon(self, req: Request, n_blocks_hit: int,
                        tail_hit: bool) -> int:
        """New blocks this request may still need at its peak length: total
        footprint minus cache-shared blocks, plus one CoW replacement if the
        shared tail block must be copied before the first append."""
        total = min(len(req.prompt) + req.sampling.max_new_tokens, self.max_len)
        return max(-(-total // self.block_size) - n_blocks_hit, 0) + int(tail_hit)

    def _paged_available(self) -> int:
        """Blocks a new request could still claim without over-committing:
        free + evictable-cache minus what live rows have reserved."""
        return (self.prefix.free_blocks + self.prefix.evictable_blocks
                - self._reserved_total)

    def _take_reserved(self, row: int, n: int) -> None:
        take = min(self._row_reserved.get(row, 0), n)
        if take:
            self._row_reserved[row] -= take
            self._reserved_total -= take

    def _ensure_blocks(self, row: int, upto_tokens: int) -> None:
        """Grow the row's block list to cover positions [0, upto_tokens)."""
        blocks = self._row_blocks[row]
        need = -(-upto_tokens // self.block_size) - len(blocks)
        if need <= 0:
            return
        new = self.prefix.allocate(need)
        if new is None:
            raise RuntimeError(
                f"paged KV pool exhausted: need {need} blocks, "
                f"{self.prefix.free_blocks} free / "
                f"{self.prefix.evictable_blocks} evictable "
                f"(num_blocks={self.num_blocks})")
        self.block_tables[row, len(blocks):len(blocks) + need] = new
        blocks.extend(new)
        self._take_reserved(row, need)

    def _ensure_writable(self, row: int, block_idx: int) -> None:
        """Copy-on-write: the block about to take an append may be shared
        with other rows or retained by the prefix index; the row gets a
        private copy first."""
        blocks = self._row_blocks[row]
        if block_idx >= len(blocks):
            return
        old = blocks[block_idx]
        if not self.prefix.needs_cow(old):
            return
        new = self.prefix.allocate(1)
        if new is None:
            raise RuntimeError("paged KV pool exhausted during copy-on-write")
        self._copy_block(old, new[0])
        blocks[block_idx] = new[0]
        self.block_tables[row, block_idx] = new[0]
        self.prefix.decref(old)
        self.prefix.cow_copies += 1
        self._take_reserved(row, 1)

    def _release_row(self, row: int, req: Request, insert: bool) -> None:
        """Return a row's blocks: index them under the sequence's tokens
        first (so the next request with this prefix skips its prefill), then
        drop the row's references."""
        blocks = self._row_blocks.pop(row, None)
        if blocks is None:
            return
        if insert and self.prefix_enabled:
            n_valid = int(self.pos[row])        # KV covers positions [0, pos)
            seq = (list(req.prompt) + list(req.output))[:n_valid]
            self.prefix.insert(seq, blocks, n_valid)
        self.prefix.release(blocks)
        self.block_tables[row, :] = -1
        self._reserved_total -= self._row_reserved.pop(row, 0)

    # ------------------------------------------------------------- interface
    def submit(self, req: Request, now: float | None = None) -> bool:
        now = time.perf_counter() if now is None else now
        limit = self.max_len - 1 - (self.cfg.num_vision_tokens or 0)
        if not self._can_chunk:
            limit = min(limit, self.buckets[-1])
        if len(req.prompt) > limit:
            # served-or-rejected, never a crash: a prompt that cannot fit a
            # cache row, or cannot be chunked on this family, bounces here
            req.state = State.REJECTED
            self.rejected_long += 1
            self._trace_reject(req, now, "prompt-too-long")
            return False
        if self.paged:
            total = min(len(req.prompt) + req.sampling.max_new_tokens,
                        self.max_len)
            if -(-total // self.block_size) > self.num_blocks:
                req.state = State.REJECTED
                self.rejected_long += 1
                self._trace_reject(req, now, "kv-unmappable")
                return False
        ok = self.scheduler.submit(req, now)
        if ok:
            self.tracer.start_trace(
                req.rid, now, replica=self._rlabel,
                prompt_tokens=len(req.prompt), slo_ttft=req.slo_ttft,
                slo_tpot=req.slo_tpot)
            if self.tracer.open_span(req.rid, "queue_wait") is None:
                self.tracer.begin(req.rid, "queue_wait", now,
                                  replica=self._rlabel)
        return ok

    def pending(self) -> int:
        return self.scheduler.depth() + self.pool.used

    # --------------------------------------------------------------- prefill
    def _admit_cost(self, req: Request) -> tuple[int, int]:
        """(padded, true) prefill tokens this request consumes in its
        admission step; cache-aware on the paged backend."""
        n = len(req.prompt)
        if self.paged:
            n_rem = n - (self._cached_prefix_len(req)
                         if self.prefix_enabled else 0)
            c = min(self.chunk, n_rem)
            return c, c
        if n <= self.buckets[-1]:
            return _round_bucket(n, self.buckets), n
        return self.chunk, min(self.chunk, n)

    def _cached_prefix_len(self, req: Request) -> int:
        """Memoised prefix-cache lookup, redone only when the index changed."""
        memo = req.extras.get("_pc_lookup")
        gen = self.prefix.generation
        if memo is None or memo[0] != gen:
            memo = (gen, self.prefix.lookup(req.prompt))
            req.extras["_pc_lookup"] = memo
        return memo[1]

    def _set_row_sampling(self, row: int, req: Request) -> None:
        self._temp[row] = req.sampling.temperature
        self._topk[row] = req.sampling.top_k
        self._topp[row] = req.sampling.top_p

    @torch.no_grad()
    def _admit_batch(self, reqs: list[Request], bucket: int, now: float) -> int:
        """Batched prefill of one bucket group: one forward, batched cache
        insertion, batched first-token sampling."""
        G = len(reqs)
        toks = np.zeros((G, bucket), np.int64)
        true = np.zeros((G,), np.int64)
        rows = []
        for i, req in enumerate(reqs):
            row = self.pool.allocate(req.rid)
            assert row is not None
            req.row, req.state, req.t_admit = row, State.PREFILL, now
            self._trace_admit(req, now, kind=f"bucket{bucket}", row=row)
            self.tracer.annotate_chunk(req.rid, now, replica=self._rlabel,
                                       tokens=len(req.prompt), pos0=0)
            rows.append(row)
            toks[i, : len(req.prompt)] = req.prompt
            true[i] = len(req.prompt)
        batch = {"tokens": self._t(toks)}
        prefix = self.cfg.num_vision_tokens or 0
        if prefix:
            # a request's patches (1, prefix, d_model), zeros where it has none
            patches = torch.zeros((G, prefix, self.cfg.d_model), dtype=torch.float32,
                                  device=self.device)
            for i, req in enumerate(reqs):
                if "patches" in req.extras:
                    patches[i] = torch.as_tensor(req.extras["patches"])[0]
            batch["patches"] = patches
        if self.cfg.is_encoder_decoder:
            # a request's frames (1, encoder_seq, d_model), zeros where it has none
            frames = torch.zeros((G, self.cfg.encoder_seq, self.cfg.d_model),
                                 dtype=torch.float32, device=self.device)
            for i, req in enumerate(reqs):
                if "frames" in req.extras:
                    frames[i] = torch.as_tensor(req.extras["frames"])[0]
            batch["frames"] = frames
        logits, row_caches = self.model.prefill(
            self.params, batch, self.max_len, true_len=self._t(true))
        self._insert_rows(row_caches, rows)
        sampled = self._sample(
            logits,
            np.array([r.sampling.temperature for r in reqs], np.float32),
            np.array([r.sampling.top_k for r in reqs], np.int64),
            np.array([r.sampling.top_p for r in reqs], np.float32))
        for i, req in enumerate(reqs):
            t = int(sampled[i])
            row = req.row
            req.output.append(t)
            req.t_first_token = now
            req.token_times.append(now)
            req.state = State.DECODE
            self.pos[row] = len(req.prompt) + prefix
            self.tokens[row, 0] = t
            self._set_row_sampling(row, req)
            self.row_req[row] = req
            self._trace_first_token(req, now)
            self._emit_first_token(req, t, now)
            self._maybe_finish_first(row, req, now)
        return sum(len(r.prompt) for r in reqs)

    def _admit_chunked(self, req: Request, now: float) -> int:
        row = self.pool.allocate(req.rid)
        assert row is not None
        req.row, req.state, req.t_admit = row, State.PREFILL, now
        self._trace_admit(req, now, kind="chunked", row=row)
        self._prefilling[row] = req
        self._consumed[row] = 0
        self._fresh.add(row)
        self.pos[row] = 0
        self._set_row_sampling(row, req)
        return row

    def _admit_paged(self, req: Request, now: float) -> int | None:
        """Admit onto the paged backend (every prompt goes through the chunk
        pipeline).  Matched prefix-cache blocks are mapped read-shared into
        the row's block table and their tokens are never prefilled.  Returns
        None — leave the request queued — when the block pool cannot cover
        the request's worst-case footprint without over-committing."""
        blocks, n_hit, tail_hit = [], 0, False
        if self.prefix_enabled:
            blocks, n_hit = self.prefix.match(req.prompt)
            tail_hit = n_hit % self.block_size != 0
        horizon = self._blocks_horizon(req, len(blocks), tail_hit)
        if tail_hit and horizon > self._paged_available():
            # the CoW slack block can be unsatisfiable when the request's
            # footprint spans the whole pool: drop the partial-tail hit
            dropped = n_hit % self.block_size
            self.prefix.decref(blocks.pop())
            self.prefix.hit_tokens -= dropped
            self.prefix.miss_tokens += dropped
            n_hit -= dropped
            tail_hit = False
            horizon = self._blocks_horizon(req, len(blocks), False)
        if horizon > self._paged_available():
            self.prefix.release(blocks)
            # nothing was served: roll the hit/miss counters back
            self.prefix.hit_tokens -= n_hit
            self.prefix.miss_tokens -= len(req.prompt) - n_hit
            return None
        row = self.pool.allocate(req.rid)
        assert row is not None
        req.row, req.state, req.t_admit = row, State.PREFILL, now
        self._trace_admit(req, now, kind="paged", row=row, cached=n_hit)
        req.prefix_hit_tokens = n_hit
        self._row_blocks[row] = list(blocks)
        self.block_tables[row, :] = -1
        self.block_tables[row, :len(blocks)] = blocks
        self._row_reserved[row] = horizon
        self._reserved_total += horizon
        self._prefilling[row] = req
        self._consumed[row] = n_hit          # cached tokens: already prefilled
        self.pos[row] = n_hit
        self._set_row_sampling(row, req)
        self._hit_tokens_step += n_hit
        return row

    @torch.no_grad()
    def _run_chunks(self, rows_n: dict[int, int], now: float, clock) -> int:
        """Advance the selected mid-prefill rows by one chunk each, in one
        call; promote rows that consumed their prompt.  The paged call runs
        over the advancing rows alone (ascending) and the blocks they map:
        the pools are shared through the block table.  The dense call runs
        over the whole pool, whose rows are its caches.  Returns the
        positions the call computed."""
        clock.enter("engine.chunk.prepare")
        C = self.chunk
        call_rows = sorted(rows_n) if self.paged else list(range(self.capacity))
        at = {row: i for i, row in enumerate(call_rows)}
        toks = np.zeros((len(call_rows), C), np.int64)
        pos0 = np.zeros((len(call_rows),), np.int64)
        nval = np.zeros((len(call_rows),), np.int64)
        fresh = []
        done_rows = []
        for row, n in rows_n.items():
            req = self._prefilling[row]
            c0 = self._consumed[row]
            self.tracer.annotate_chunk(req.rid, now, replica=self._rlabel,
                                       tokens=n, pos0=c0)
            toks[at[row], :n] = req.prompt[c0:c0 + n]
            pos0[at[row]] = c0
            nval[at[row]] = n
            if row in self._fresh:
                fresh.append(row)
            if self.paged:
                # map blocks for this chunk's span; CoW a shared first block
                self._ensure_blocks(row, c0 + n)
                self._ensure_writable(row, c0 // self.block_size)
            self._consumed[row] = c0 + n
            self.pos[row] = c0 + n
            if c0 + n >= len(req.prompt):
                done_rows.append(row)
        self._fresh -= set(rows_n)
        if self.paged:
            # the table's columns up to the furthest position written: keys
            # past it are masked, writes past it none
            n_blk = -(-int((pos0 + nval).max()) // self.block_size)
            args = (self._t(toks), self._t(pos0), self._t(nval), self.caches,
                    self._t(self.block_tables[call_rows, :n_blk]))
            clock.enter("engine.chunk.forward", device=True)
            logits, _ = self.model.prefill_chunk_paged(self.params, *args)
        else:
            if fresh:
                # a reused row must not leak its previous occupant's KV,
                # ring positions or SSM state
                idx = self._t(np.asarray(fresh, np.int64))
                for t, ax, fill in P.tree_zip(self.caches, self._batch_axes,
                                              self._reset_vals):
                    t.index_fill_(ax, idx, fill)
            args = (self._t(toks), self._t(pos0), self._t(nval), self.caches)
            clock.enter("engine.chunk.forward", device=True)
            logits, _ = self.model.prefill_chunk(self.params, *args)
        clock.leave()
        if not done_rows:
            return len(call_rows) * C
        if self.paged:
            # the sampler sees the pool's rows, so each row's draw is the
            # one a pool-wide call gives it
            full = logits.new_zeros((self.capacity, logits.shape[1]))
            logits = full.index_copy_(0, self._t(np.asarray(call_rows, np.int64)),
                                      logits)
        sampled = self._sample(logits, self._temp, self._topk, self._topp,
                               clock, "chunk")
        for row in done_rows:
            req = self._prefilling.pop(row)
            del self._consumed[row]
            t = int(sampled[row])
            req.output.append(t)
            req.t_first_token = now
            req.token_times.append(now)
            req.state = State.DECODE
            self.pos[row] = len(req.prompt)
            self.tokens[row, 0] = t
            self.row_req[row] = req
            self._trace_first_token(req, now)
            self._emit_first_token(req, t, now)
            self._maybe_finish_first(row, req, now)
        return len(call_rows) * C

    def _maybe_finish_first(self, row: int, req: Request, now: float) -> None:
        """A request can be complete at its first (prefill) token, in which
        case it must not receive a same-step decode token."""
        stop = req.sampling.stop_token
        if (len(req.output) >= req.sampling.max_new_tokens
                or (stop is not None and req.output[-1] == stop)
                or self.pos[row] >= self.max_len - 1):
            self._retire(row, now)

    def _retire(self, row: int, now: float) -> None:
        req = self.row_req.pop(row)
        req.state = State.DONE
        req.t_finish = now
        req.row = None
        stop = req.sampling.stop_token
        req.finish_reason = ("stop" if stop is not None and req.output
                             and req.output[-1] == stop else "length")
        if self.paged:
            self._release_row(row, req, insert=True)
        self.pool.free(row)
        self.finished.append(req)
        self.tracer.end(req.rid, "decode", now, tokens=len(req.output))
        self.tracer.finish(req.rid, now)
        self.emit_event(FinishEvent(t=now, rid=req.rid,
                                    reason=req.finish_reason,
                                    n_tokens=len(req.output)))

    # ------------------------------------------------------------- events
    def emit_event(self, ev: EngineEvent) -> None:
        """Append to the engine's event stream (drained into the next
        ``StepStats.events``)."""
        self._pending_events.append(ev)
        if isinstance(ev, PreemptEvent):
            self._c_preempts.inc(replica=self._rlabel, reason=ev.reason)
        elif isinstance(ev, FinishEvent):
            self._c_finished.inc(replica=self._rlabel, reason=ev.reason)

    def drain_events(self) -> list[EngineEvent]:
        """Return and clear the pending event stream."""
        ev, self._pending_events = self._pending_events, []
        return ev

    def _emit_first_token(self, req: Request, token: int, now: float) -> None:
        self.emit_event(FirstTokenEvent(t=now, rid=req.rid, token=token,
                                        index=0))

    # ------------------------------------------------------- observability
    def set_tracer(self, tracer) -> None:
        """Rebind to a shared (cluster-wide) tracer; also refreshes the
        replica label, which the control plane sets via ``lb_id``."""
        self.tracer = tracer
        self._rlabel = str(getattr(self, "replica_label", getattr(self, "lb_id", 0)))

    def set_metrics(self, registry) -> None:
        """Rebind every instrument onto a shared (cluster-wide) registry."""
        self._bind_instruments(registry)

    def _bind_instruments(self, registry) -> None:
        self.metrics = registry
        self._rlabel = str(getattr(self, "replica_label", getattr(self, "lb_id", 0)))
        self._c_prefill_tok = registry.counter(
            "engine_prefill_tokens_total",
            "Prompt tokens prefilled (true) / compute launched (padded)",
            ("replica", "kind"))
        self._c_decode_tok = registry.counter(
            "engine_decode_tokens_total", "Decode tokens emitted", ("replica",))
        self._c_admissions = registry.counter(
            "engine_admissions_total", "Requests admitted onto a row",
            ("replica",))
        self._c_finished = registry.counter(
            "engine_requests_finished_total", "Requests retired, by reason",
            ("replica", "reason"))
        self._c_preempts = registry.counter(
            "engine_preemptions_total",
            "Rows displaced pre-finish, by reason (slo-decode-pressure / "
            "migrate / requeued)", ("replica", "reason"))
        self._c_rejections = registry.counter(
            "serving_rejections_total",
            "Requests rejected, by reason (queue-full / timeout / "
            "prompt-too-long / kv-unmappable)", ("replica", "reason"))
        self._g_occupancy = registry.gauge(
            "engine_batch_occupancy", "Rows occupied / capacity", ("replica",))
        self._g_queue = registry.gauge(
            "engine_queue_depth", "Scheduler queue depth", ("replica",))
        self._g_kv_util = registry.gauge(
            "engine_kv_util", "KV memory utilization fraction", ("replica",))
        self._g_kv_frag = registry.gauge(
            "engine_kv_frag", "Wasted tail-of-block KV slots fraction",
            ("replica",))
        self._h_step = registry.histogram(
            "engine_step_seconds",
            "Host seconds per step phase (admit / chunk / decode / sample / emit)",
            ("replica", "phase"))
        if self.paged:
            self._c_prefix = registry.counter(
                "prefix_cache_tokens_total",
                "Prefix-cache token outcomes (hit / miss)",
                ("replica", "kind"))
            self._c_prefix_ev = registry.counter(
                "prefix_cache_events_total",
                "Prefix-cache block events (evictions / cow_copies / "
                "inserted_blocks)", ("replica", "kind"))
            self._g_blocks = registry.gauge(
                "prefix_cache_blocks", "KV blocks by state (used / cached)",
                ("replica", "kind"))

    def _observe_step(self, st: StepStats, phases: dict[str, float]) -> None:
        """Mirror one StepStats and the host seconds of the step's phases
        (admit / chunk / decode / sample / emit, those it ran) into the
        registry (never affects serving)."""
        rl = self._rlabel
        if st.prefill_tokens:
            self._c_prefill_tok.inc(st.prefill_tokens_true, replica=rl,
                                    kind="true")
            self._c_prefill_tok.inc(st.prefill_tokens_padded, replica=rl,
                                    kind="padded")
        if st.tokens_out:
            self._c_decode_tok.inc(st.tokens_out, replica=rl)
        for phase, s in phases.items():
            self._h_step.observe(s, replica=rl, phase=phase)
        if st.n_prefill:
            self._c_admissions.inc(st.n_prefill, replica=rl)
        self._g_occupancy.set(st.occupancy / max(self.capacity, 1), replica=rl)
        self._g_queue.set(st.queue_depth, replica=rl)
        self._g_kv_util.set(st.kv_util, replica=rl)
        self._g_kv_frag.set(st.kv_frag, replica=rl)
        if self.paged:
            self._c_prefix.peg(self.prefix.hit_tokens, replica=rl, kind="hit")
            self._c_prefix.peg(self.prefix.miss_tokens, replica=rl,
                               kind="miss")
            self._c_prefix_ev.peg(self.prefix.evictions, replica=rl,
                                  kind="evictions")
            self._c_prefix_ev.peg(self.prefix.cow_copies, replica=rl,
                                  kind="cow_copies")
            self._c_prefix_ev.peg(self.prefix.inserted_blocks, replica=rl,
                                  kind="inserted_blocks")
            self._g_blocks.set(st.kv_blocks_used, replica=rl, kind="used")
            self._g_blocks.set(st.kv_blocks_cached, replica=rl, kind="cached")

    def _trace_reject(self, req: Request, now: float, reason: str) -> None:
        """Rejection: a complete (instant) trace plus the rejection counter;
        also the scheduler's ``on_reject`` hook."""
        self._c_rejections.inc(replica=self._rlabel, reason=reason)
        self.tracer.start_trace(req.rid, now, replica=self._rlabel,
                                prompt_tokens=len(req.prompt))
        self.tracer.finish(req.rid, now, status=f"rejected:{reason}")

    def _trace_admit(self, req: Request, now: float, *, kind: str, row: int,
                     cached: int = 0) -> None:
        """Queue residency ends, prefill phase opens."""
        tr, rid, rl = self.tracer, req.rid, self._rlabel
        tr.end(rid, "queue_wait", now)
        tr.annotate(rid, "admission", now, replica=rl, row=row, kind=kind,
                    cached_prefix_tokens=cached)
        tr.begin(rid, "prefill", now, replica=rl,
                 prompt_tokens=len(req.prompt), cached_prefix_tokens=cached)

    def _trace_first_token(self, req: Request, now: float) -> None:
        """Prefill phase closes at the first token; decode phase opens."""
        self.tracer.end(req.rid, "prefill", now)
        self.tracer.begin(req.rid, "decode", now, replica=self._rlabel)

    # --------------------------------------------------------- SLO preempt
    def _preempt_freshest_prefill(self, now: float) -> bool:
        """Displace the most recently admitted mid-prefill row back to the
        queue head.  On the paged backend its consumed-prefix blocks are
        donated to the prefix index first; a dense row restarts its
        prefill."""
        if not self._prefilling:
            return False
        row = next(reversed(self._prefilling))      # insertion order = age
        req = self._prefilling.pop(row)
        self._consumed.pop(row, None)
        self._fresh.discard(row)
        if self.paged:
            self._release_row(row, req, insert=True)
        self.pool.free(row)
        self.pos[row] = 0
        req.state = State.QUEUED
        req.row = None
        req.t_admit = None
        req.preemptions += 1
        self.preemptions += 1
        self.scheduler.queue.appendleft(req)
        self.tracer.end(req.rid, "prefill", now, status="preempted")
        self.tracer.annotate(req.rid, "slo_guard_preempt", now,
                             replica=self._rlabel)
        self.tracer.begin(req.rid, "queue_wait", now, replica=self._rlabel,
                          requeued=True)
        self.emit_event(PreemptEvent(t=now, rid=req.rid,
                                     reason="slo-decode-pressure"))
        return True

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self, now: float | None = None) -> StepStats:
        """One engine iteration: chunk continuations -> admit (batched
        bucket prefills + new chunk starts) -> one decode step.  Its phases
        (``core.tracing.STEP_PHASES``) run on one stopwatch, which
        ``StepStats``, ``engine_step_seconds`` and, while the tracer
        records steps or a profiler runs, the step's spans read; the model's ranges open with
        the step's while a profiler runs."""
        now = time.perf_counter() if now is None else now
        clock = self.tracer.step_clock(now, self._rlabel,
                                       self.device.type == "cuda")
        self.model.ranges = clock.ranges
        try:
            return self._step(now, clock)
        finally:
            clock.close()

    def _step(self, now: float, clock) -> StepStats:
        clock.enter("engine.admit")
        budget = self.scheduler.cfg.prefill_token_budget
        # a non-positive budget would starve admission forever
        remaining = math.inf if budget is None else max(budget, 1)
        prefill_tokens = 0
        prefill_padded = 0
        if self.paged:
            self._hit_tokens_step = 0

        # 0. SLO guard: decode rows at TPOT-deadline risk withhold new
        # admissions; a persistent streak preempts the freshest prefill
        scfg = self.scheduler.cfg
        at_risk: list[Request] = []
        preempted = 0
        if scfg.slo_guard:
            at_risk = deadline_risk(self.row_req.values(),
                                    scfg.slo_guard_margin)
            self._risk_streak = self._risk_streak + 1 if at_risk else 0
            if at_risk and self._risk_streak >= scfg.slo_guard_patience:
                if self._preempt_freshest_prefill(now):
                    preempted = 1

        # 1. continue in-flight chunked prefills (admission order); the
        # oldest row always advances
        rows_n: dict[int, int] = {}
        for row, req in self._prefilling.items():
            n = min(self.chunk, len(req.prompt) - self._consumed[row])
            if rows_n and remaining < n:
                continue
            rows_n[row] = n
            remaining -= n
            prefill_tokens += n
            prefill_padded += n if self.paged else self.chunk

        # 2. admission under the remaining budget
        incoming: list[Request] = []
        if remaining > 0 and not at_risk:
            free = self.capacity - self.pool.used
            incoming = self.scheduler.next_batch(
                free, now, budget=None if budget is None else int(remaining),
                cost=self._admit_cost)
        groups: dict[int, list[Request]] = {}
        admitted = 0
        for i, req in enumerate(incoming):
            n = len(req.prompt)
            if self.paged:
                row = self._admit_paged(req, now)
                if row is None:
                    # KV blocks exhausted: requeue in FCFS order and stop
                    for r in reversed(incoming[i:]):
                        self.scheduler.queue.appendleft(r)
                    break
                rows_n[row] = min(self.chunk, n - self._consumed[row])
                prefill_tokens += rows_n[row]
                prefill_padded += rows_n[row]
                admitted += 1
            elif n <= self.buckets[-1]:
                groups.setdefault(_round_bucket(n, self.buckets), []).append(req)
                admitted += 1
            elif self._can_chunk:
                row = self._admit_chunked(req, now)
                rows_n[row] = min(self.chunk, n)
                prefill_tokens += rows_n[row]
                prefill_padded += self.chunk
                admitted += 1
            else:  # submit() bounces these; a request queued otherwise too
                req.state = State.REJECTED
                self.rejected_long += 1
        for bucket in sorted(groups):
            prefill_tokens += self._admit_batch(groups[bucket], bucket, now)
            prefill_padded += bucket * len(groups[bucket])

        # 3. one chunk call for all advancing rows
        positions = self._run_chunks(rows_n, now, clock) if rows_n else 0

        # 4. decode
        tokens_out = 0
        if self.row_req:
            clock.enter("engine.decode.prepare")
            if self.paged:
                # map the block each row's next token lands in (CoW'd if
                # shared); rows that are not live write nothing
                live = np.zeros((self.capacity,), bool)
                for row in self.row_req:
                    live[row] = True
                    self._ensure_blocks(row, int(self.pos[row]) + 1)
                    self._ensure_writable(
                        row, int(self.pos[row]) // self.block_size)
                args = (self._t(self.tokens), self._t(self.pos), self.caches,
                        self._t(self.block_tables), self._t(live))
                clock.enter("engine.decode.forward")
                logits, _ = self.model.decode_step_paged(self.params, *args)
            else:
                # rows mid chunked prefill must not take the decode write
                # (each layer's cache writer masks it, every entry)
                live = None
                if self._prefilling:
                    live = np.ones((self.capacity,), bool)
                    live[list(self._prefilling)] = False
                    live = self._t(live)
                args = (self._t(self.tokens), self._t(self.pos), self.caches)
                clock.enter("engine.decode.forward")
                logits, _ = self.model.decode_step(self.params, *args, live=live)
            clock.leave()
            sampled = self._sample(logits, self._temp, self._topk, self._topp,
                                   clock, "decode")
            clock.enter("engine.emit")
            for row, req in list(self.row_req.items()):
                t = int(sampled[row])
                req.output.append(t)
                req.token_times.append(now)
                tokens_out += 1
                self.pos[row] += 1
                self.tokens[row, 0] = t
                self.emit_event(TokenEvent(t=now, rid=req.rid, token=t,
                                           index=len(req.output) - 1))
                stop = req.sampling.stop_token
                if (len(req.output) >= req.sampling.max_new_tokens
                        or (stop is not None and t == stop)
                        or self.pos[row] >= self.max_len - 1):
                    self._retire(row, now)
        else:
            clock.enter("engine.emit")

        st = StepStats(t=now, **clock.stats(),
                       n_prefill=admitted, occupancy=self.pool.used,
                       queue_depth=self.scheduler.depth(), tokens_out=tokens_out,
                       prefill_tokens=prefill_tokens, chunk_rows=len(rows_n),
                       prefill_tokens_padded=prefill_padded,
                       prefill_tokens_true=prefill_tokens,
                       events=self.drain_events(), preempted=preempted)
        if self.paged:
            alloc = sum(len(b) for b in self._row_blocks.values()) \
                * self.block_size
            live_tok = int(sum(int(self.pos[r]) for r in self._row_blocks))
            st.prefix_hit_tokens = self._hit_tokens_step
            st.prefix_hit_rate = self.prefix.hit_rate()
            st.kv_blocks_used = self.prefix.used_blocks
            st.kv_blocks_cached = self.prefix.cached_blocks
            st.kv_util = self.prefix.utilization()
            st.kv_frag = 0.0 if alloc == 0 else 1.0 - live_tok / alloc
        else:
            st.kv_util = self.pool.utilization()
        self._observe_step(st, clock.phases())
        self.history.append(st)
        clock.finish(kind="chunk" if rows_n else "decode",
                     positions_computed=positions,
                     tokens_valid=sum(rows_n.values()))
        return st

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.pending() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # --------------------------------------------------------- migration
    def _find_row(self, rid: int) -> tuple[int, Request, str]:
        """Locate a live request by rid: (row, request, phase) where phase
        is "decode" (prefill complete) or "prefill" (mid-chunked-prefill,
        extractable at its current chunk boundary)."""
        for row, q in self.row_req.items():
            if q.rid == rid:
                return row, q, "decode"
        for row, q in self._prefilling.items():
            if q.rid == rid:
                return row, q, "prefill"
        raise KeyError(f"rid {rid} not active here")

    def migratable_requests(self) -> list[Request]:
        """Live requests a migration payload can be built for: every decode
        row, plus mid-prefill rows that have consumed at least one chunk
        (a consumed==0 dense row has not run its cache reset yet — there is
        nothing coherent to extract, only a request to requeue)."""
        out = list(self.row_req.values())
        out += [q for row, q in self._prefilling.items()
                if self._consumed.get(row, 0) > 0]
        return out

    def migration_sequence(self, rid: int) -> list[int]:
        """Tokens whose KV is materialised for this request — what a
        destination's prefix cache can be probed with before transfer."""
        row, req, _ = self._find_row(rid)
        n = int(self.pos[row])
        return (list(req.prompt) + list(req.output))[:n]

    def can_adopt(self, req: Request, n_valid: int,
                  n_keep_blocks: int = 0) -> bool:
        """Cheap adopt admissibility probe — no row taken, no cache data
        touched, no refcounts moved.  ``n_keep_blocks``: full blocks this
        engine's prefix cache already holds for the sequence (it would
        reuse, not re-allocate, them)."""
        if self.pool.used >= self.capacity:
            return False
        if not self.paged:
            return True
        n_total = -(-n_valid // self.block_size)
        future = self._blocks_horizon(req, n_total, False)
        return (n_total - n_keep_blocks) + future <= self._paged_available()

    def kv_per_block_bytes(self) -> int:
        """Bytes one KV block holds across every layer pool (paged only)."""
        assert self.paged
        return sum(t.nbytes // t.shape[axes[n]]
                   for pool, axes in zip(self.caches, self._pool_block_axes)
                   for n, t in pool.items())

    def _gather_blocks(self, block_ids: list[int]) -> list[dict]:
        """Per-layer (n_blocks, block_size, ...) slabs for the given pool
        blocks — the data plane of a paged migration payload.  A copy
        (``index_select``), never a view: the source donates these blocks
        to its prefix index, and a request admitted next may overwrite them
        while the payload is still in flight."""
        ids = self._t(np.asarray(block_ids, np.int64))
        return [{n: t.index_select(axes[n], ids) for n, t in pool.items()}
                for pool, axes in zip(self.caches, self._pool_block_axes)]

    @torch.no_grad()
    def _scatter_blocks(self, data: list[dict], block_ids: list[int],
                        lo: int) -> None:
        """Write payload slabs (skipping the first ``lo`` blocks — the
        destination already holds them) into the given fresh pool blocks,
        cast to the pool's dtype."""
        if not block_ids:
            return
        ids = self._t(np.asarray(block_ids, np.int64))
        for pool, d, axes in zip(self.caches, data, self._pool_block_axes):
            for n, t in pool.items():
                ax = axes[n]
                sl = d[n].narrow(ax, lo, d[n].shape[ax] - lo)
                t.index_copy_(ax, ids, sl.to(t.dtype))

    def extract_row(self, rid: int, now: float | None = None):
        """Remove a live request, returning its migration payload
        (Llumnix-style pause-and-copy handoff).  Works for decode rows and
        for mid-chunked-prefill rows at their current chunk boundary — the
        payload carries the prefill progress (``phase``/``pos``) so the
        destination resumes exactly where the source stopped.

        Dense payload: the row's caches, every leaf copied at batch size 1.
        Paged payload: per-layer (n_blocks, block_size, ...) slabs for the
        mapped blocks plus the token sequence they hold, so the destination
        can re-allocate through its own PrefixCache and skip blocks it
        already caches.  The source row is freed; its blocks are donated to
        the source's prefix index first, so a rollback re-adopt (or the
        next request with this prefix) is mostly cache hits."""
        row, req, phase = self._find_row(rid)
        if phase == "prefill" and self._consumed.get(row, 0) <= 0:
            raise ValueError(f"rid {rid} has not completed a chunk yet — "
                             "requeue it instead of migrating")
        n_valid = int(self.pos[row])
        payload: dict[str, Any] = {"pos": n_valid, "phase": phase}
        if phase == "decode":
            payload["last_token"] = int(self.tokens[row, 0])
        if self.paged:
            blocks = self._row_blocks[row][: -(-n_valid // self.block_size)]
            payload["kind"] = "paged"
            payload["seq"] = self.migration_sequence(rid)
            payload["blocks"] = self._gather_blocks(blocks)
            payload["n_blocks"] = len(blocks)
        else:
            idx = self._t(np.asarray([row], np.int64))
            payload["kind"] = "dense"
            payload["caches"] = P.tree_map(lambda t, ax: t.index_select(ax, idx),
                                           self.caches, self._batch_axes)
        if phase == "decode":
            del self.row_req[row]
        else:
            del self._prefilling[row]
            del self._consumed[row]
            self._fresh.discard(row)
        if self.paged:
            self._release_row(row, req, insert=True)
        req.state = State.MIGRATING
        req.row = None
        req.migrations += 1
        self.pool.free(row)
        now = time.perf_counter() if now is None else now
        # close this replica's slice of the phase span and ship the span
        # context with the KV: the destination continues the same trace
        self.tracer.end(rid, "decode" if phase == "decode" else "prefill",
                        now, status="migrate-out")
        payload["trace"] = self.tracer.export_context(rid)
        self.emit_event(PreemptEvent(t=now, rid=rid, reason="migrate"))
        return req, payload

    def begin_adopt(self, req: Request, payload: dict,
                    now: float | None = None) -> int | None:
        """Reserve everything an incoming migration needs *before* any KV
        lands: a batch row and, on the paged backend, the full block plan —
        destination-cached full blocks are reused (their refcounts pin them
        against eviction for the transfer's whole flight), fresh blocks are
        allocated through the prefix cache with the same reservation-based
        admission as ``_admit_paged``.

        Returns an opaque ticket for ``feed_adopt``/``commit_adopt``/
        ``abort_adopt``, or None when no row or no admissible block plan is
        available (nothing reserved — the caller rolls back at the source).
        The pending row is invisible to stepping and migration until commit
        activates it."""
        kind = payload.get("kind", "dense")
        want = "paged" if self.paged else "dense"
        if kind != want:
            raise ValueError(f"cannot adopt a {kind!r} payload on a {want!r} "
                             "engine — convert the payload first "
                             "(convert_payload) or migrate same-backend")
        row = self.pool.allocate(req.rid)
        if row is None:
            return None
        st: dict[str, Any] = {"req": req, "row": row, "payload": payload,
                              "n_keep": 0, "blocks": None, "chunks": {},
                              "expected": 1}
        if self.paged:
            seq, n_valid = payload["seq"], payload["pos"]
            n_total = -(-n_valid // self.block_size)
            future = self._blocks_horizon(req, n_total, False)
            if self.prefix_enabled:
                plan = self.prefix.adopt_blocks(seq, n_valid, future,
                                                self._reserved_total)
            else:
                plan = None
                if n_total + future <= self._paged_available():
                    got = self.prefix.allocate(n_total)
                    plan = (got, 0) if got is not None else None
            if plan is None:
                self.pool.free(row)
                return None
            blocks, n_keep = plan
            self._row_blocks[row] = blocks
            self.block_tables[row, :] = -1
            self.block_tables[row, : len(blocks)] = blocks
            self._row_reserved[row] = future
            self._reserved_total += future
            st["blocks"], st["n_keep"] = blocks, n_keep
            # one transfer chunk per block the destination doesn't hold
            st["expected"] = payload["n_blocks"] - n_keep
        self.pos[row] = 0          # no live tokens until commit
        self._next_ticket += 1
        self._pending_adopt[self._next_ticket] = st
        return self._next_ticket

    def feed_adopt(self, ticket: int, index: int, data) -> None:
        """Land one transfer chunk of an in-progress adoption.  Paged:
        ``data`` is the per-layer single-block slab for payload block
        ``n_keep + index``, scattered straight into the reserved pool block
        (chunks may arrive in any order; duplicates are ignored).  Dense:
        the full-row caches, buffered — the pool write happens at commit so
        an in-flight transfer never races the whole-batch decode writes."""
        st = self._pending_adopt[ticket]
        if index in st["chunks"]:
            return
        if self.paged:
            block = st["blocks"][st["n_keep"] + index]
            self._scatter_blocks(data, [block], 0)
            st["chunks"][index] = True
        else:
            st["chunks"][index] = data

    def commit_adopt(self, ticket: int, now: float | None = None) -> Request:
        """Activate a fully-transferred adoption: donate the request's full
        blocks into the radix index (the partial tail stays private so the
        row's own appends never trigger a copy-on-write), restore
        position/sampling state, continue the request's trace here, and
        make the row live for the next step."""
        now = time.perf_counter() if now is None else now
        st = self._pending_adopt.pop(ticket)
        req, row, payload = st["req"], st["row"], st["payload"]
        assert len(st["chunks"]) >= st["expected"], \
            "commit_adopt before every chunk landed"
        if self.paged:
            seq, n_valid = payload["seq"], payload["pos"]
            if self.prefix_enabled:
                self.prefix.insert(seq, st["blocks"],
                                   (n_valid // self.block_size)
                                   * self.block_size)
            req.extras["adopt_hit_blocks"] = st["n_keep"]
        else:
            self._insert_rows(st["chunks"][0], [row])
        self.pos[row] = payload["pos"]
        self._set_row_sampling(row, req)
        req.row = row
        # continue the request's trace here: same trace id, span ids offset
        # past the source's (no-op import when the cluster shares a tracer)
        self.tracer.import_context(payload.get("trace"))
        if payload["phase"] == "decode":
            self.tokens[row, 0] = payload["last_token"]
            self.row_req[row] = req
            req.state = State.DECODE
            self.tracer.begin(req.rid, "decode", now, replica=self._rlabel,
                              migrated_in=True, resume_pos=payload["pos"])
        else:
            # mid-prefill handoff: resume the chunk pipeline at the boundary
            self._prefilling[row] = req
            self._consumed[row] = payload["pos"]
            req.state = State.PREFILL
            self.tracer.begin(req.rid, "prefill", now, replica=self._rlabel,
                              migrated_in=True, resume_pos=payload["pos"])
        return req

    def abort_adopt(self, ticket: int) -> None:
        """Drop an in-progress adoption and return every reservation."""
        st = self._pending_adopt.pop(ticket)
        if self.paged:
            self._release_row(st["row"], st["req"], insert=False)
        self.pool.free(st["row"])

    def adopt(self, req: Request, payload: dict, now: float | None = None) -> bool:
        """Install a migrated request synchronously (same cfg, max_len and
        block_size; use ``convert_payload`` across KV backends).  Returns
        False — leaving this engine untouched — when no row or, on the
        paged backend, no admissible block plan is available.

        Expressed as begin/feed-all/commit so the synchronous path and the
        transport's block-granular async path share one implementation."""
        now = time.perf_counter() if now is None else now
        ticket = self.begin_adopt(req, payload, now)
        if ticket is None:
            return False
        st = self._pending_adopt[ticket]
        if self.paged:
            # one-shot scatter of the whole slab, skipping reused blocks
            self._scatter_blocks(payload["blocks"],
                                 st["blocks"][st["n_keep"]:], st["n_keep"])
            st["chunks"] = {i: True for i in range(st["expected"])}
        else:
            st["chunks"][0] = payload["caches"]
        self.commit_adopt(ticket, now)
        return True

    # --------------------------------------- cross-backend payload conversion
    def _all_seq_axes(self) -> bool:
        return all(ax is not None for ax in P.tree_leaves(self._seq_axes))

    def can_convert(self, other) -> bool:
        """Whether a migration payload from ``other`` (the opposite KV
        backend) is convertible to this engine's layout.  Any cache leaf
        without a KV sequence axis (SSM state, conv tails: no block
        representation) makes it unservable."""
        return (self.model.supports_paged()
                and other.model.supports_paged()
                and self.max_len == other.max_len
                and self._all_seq_axes())

    def convert_payload(self, req: Request, payload: dict) -> dict | None:
        """Rebuild a migration payload from the other KV backend into this
        engine's layout, leaf by leaf (the block axis sits where the batch
        axis was, the slot axis where the sequence axis was).  Paged ->
        dense flattens block slabs back into one padded row; dense -> paged
        slices the row into ``block_size`` slots.  Positions past ``pos``
        are zero-padding the decode mask never reads.  Returns None for
        shapes ``can_convert`` rejects."""
        kind = payload.get("kind", "dense")
        want = "paged" if self.paged else "dense"
        if kind == want:
            return payload
        if not (self._all_seq_axes() and self.model.supports_paged()):
            return None
        pos = payload["pos"]
        out = {k: v for k, v in payload.items()
               if k not in ("kind", "seq", "blocks", "n_blocks", "caches")}
        out["kind"] = want
        if want == "dense":
            caches = []
            for layer, bax, lens in zip(payload["blocks"], self._batch_axes,
                                        self._seq_lens):
                entry = {}
                for n, d in layer.items():
                    ax, L = bax[n], lens[n]
                    x = d.flatten(ax, ax + 1)       # (.., nb * slot, ..)
                    if x.shape[ax] < L:
                        pad = list(x.shape)
                        pad[ax] = L - x.shape[ax]
                        x = torch.cat([x, x.new_zeros(pad)], dim=ax)
                    else:
                        x = x.narrow(ax, 0, L)
                    entry[n] = x.unsqueeze(ax)
                caches.append(entry)
            out["caches"] = caches
        else:
            bs = self.block_size
            nb = -(-pos // bs)
            blocks = []
            for layer, bax, sax in zip(payload["caches"], self._batch_axes,
                                       self._seq_axes):
                entry = {}
                for n, d in layer.items():
                    ax, sx = bax[n], sax[n]
                    x = d.squeeze(ax)
                    s = sx - 1 if ax < sx else sx
                    if x.shape[s] < nb * bs:
                        pad = list(x.shape)
                        pad[s] = nb * bs - x.shape[s]
                        x = torch.cat([x, x.new_zeros(pad)], dim=s)
                    else:
                        x = x.narrow(s, 0, nb * bs)
                    entry[n] = x.unflatten(s, (nb, bs))
                blocks.append(entry)
            out["seq"] = (list(req.prompt) + list(req.output))[:pos]
            out["n_blocks"] = nb
            out["blocks"] = blocks
        return out

    # ------------------------------------------------- cluster cache directory
    def attach_cache_directory(self, directory, replica_id: int | None = None) -> None:
        """Start publishing this replica's prefix-index deltas (insert,
        evict) into a cluster cache directory, and push the current index
        so the directory is warm from the first lookup.  A no-op on dense
        or prefix-cache-disabled engines — they have nothing to advertise."""
        if not (self.paged and self.prefix_enabled):
            return
        rid = replica_id if replica_id is not None \
            else getattr(self, "lb_id", id(self))
        self.prefix.attach_sink(directory, rid)
        directory.reconcile(rid, self.prefix.reachable_chains())

    def detach_cache_directory(self, directory=None) -> None:
        """Stop publishing; with ``directory`` given, also invalidate every
        entry this replica claimed (scale-down: its pool is going away)."""
        if not self.paged:
            return
        if directory is not None and self.prefix.replica_id is not None:
            directory.drop_replica(self.prefix.replica_id)
        self.prefix.detach_sink()

    def reconcile_cache_directory(self, directory) -> tuple[int, int]:
        """Periodic anti-entropy: replace the directory's view of this
        replica with the chains its radix tree can actually serve."""
        if not (self.paged and self.prefix_enabled):
            return (0, 0)
        rid = self.prefix.replica_id
        if rid is None:
            rid = getattr(self, "lb_id", id(self))
        return directory.reconcile(rid, self.prefix.reachable_chains())

    def kv_utilization(self) -> float:
        """KV memory in use as a fraction of the backend's budget: live
        blocks over the pool on the paged backend, occupied rows over
        capacity on dense."""
        return self.prefix.utilization() if self.paged else self.pool.utilization()

    def kv_bytes(self, rid: int) -> int:
        """Migration payload size, scaled by the request's sequence length:
        leaves with a KV sequence axis are charged min(pos, L) of their L
        slots; per-row state without one (SSM state, conv tails) is charged
        in full.  On the paged backend a request is charged its mapped
        blocks."""
        row, _, _ = self._find_row(rid)
        if self.paged:
            return self.kv_per_block_bytes() * len(self._row_blocks[row])
        n = int(self.pos[row])
        total = 0
        for t, ax, L in P.tree_zip(self.caches, self._batch_axes, self._seq_lens):
            per_row = t.nbytes // t.shape[ax]
            if L is not None:
                per_row = per_row * min(n, L) // L
            total += per_row
        return total
