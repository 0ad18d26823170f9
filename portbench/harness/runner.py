"""One run of a cell.

1. The configuration's weights are drawn on the device from the seed.
2. One ``repro_torch.serving.InferenceEngine`` is built with the paged KV
   backend, the kernels and the prefix cache on: the entry the window
   drives.
3. Set-up warms every shape the traffic uses (the pool-wide chunk call,
   the decode step, the sampler): an open loop with shared prompts sends
   each shared prompt once, as a server in its steady state has them
   cached; a closed loop sends two short requests and then its first
   request per client, and the window opens once every one has its
   first token.
4. The window: the harness's loop plays the server's event loop over the
   engine's step protocol (``submit(req, now)``, ``step(now)``, the
   ``StepStats.events`` token stream), as ``CompletionsAPI._pump`` drives
   it.  It submits each request whose due time has passed, stamped with
   that due time, calls ``step()``, and stamps every token of the step with
   the host clock after ``step()`` returns (the sampler ends in ``.cpu()``,
   so the step's device work is done by then).  An open loop then drains:
   it steps on, with no further arrivals, until every request due in the
   window has its first token, at most ``drain_s`` seconds.
5. Once the window has closed and the peak memory is read, the engine is
   freed and the check compares a sample of the finished requests with
   the plain reference (``harness/check.py``).

A traced run (``trace``) also synchronises after every step and profiles a
bounded slice of steps in the middle of the window; the readers of the
per-layer metrics take their numbers from it and from the records of the
steps outside it.  A step that runs a chunk call comes once in many, so
the slice covers whole periods of the step mix: it opens after a chunk
step and closes on one, once it holds ``SLICE_CHUNKS`` chunk steps and
the cell's ``profile_steps`` steps (``slice_done``).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from portbench.harness import check as checks
from portbench.harness import spec, trace, weights
from portbench.traffic import generator

WARM_RID = 1 << 40          # request ids of set-up's own requests
SLICE_AT = 0.4              # the profiled slice starts this far into the window
SLICE_CHUNKS = 3            # ... covers this many chunk periods
SLICE_MAX_S = 20.0          # ... or ends after this many seconds
DRAIN_S = 60.0


@dataclasses.dataclass
class StepRec:
    t0: float                  # host clock at the call (the ``now`` it is given)
    t1: float                  # host clock when it returned
    chunk_rows: int
    tokens_out: int
    profiled: bool
    decode_ctx: list[int]      # context of every token a decode step produced


@dataclasses.dataclass
class ReqRec:
    rid: int
    item: generator.Item
    due: float                 # host clock it was due (submitted) at
    req: object = None         # the engine's Request
    stamps: list[tuple[int, float]] = dataclasses.field(default_factory=list)
    finish: float | None = None
    rejected: bool = False

    @property
    def first(self) -> float | None:
        return self.stamps[0][1] if self.stamps else None


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    conf: dict
    seconds: float
    traced: bool
    setup_s: float
    t0: float                  # the window
    t1: float
    steps: list[StepRec]
    reqs: dict[int, ReqRec]
    tracer: object
    slice: trace.Slice | None = None
    queue_mid: int = 0         # queue depth at the window's middle and end
    queue_end: int = 0

    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def window_reqs(self) -> list[ReqRec]:
        """Requests due in the window (an open loop's arrivals, a closed
        loop's sends)."""
        return [r for r in self.reqs.values() if self.in_window(r.due)]

    def ttft_ms(self) -> list[float]:
        return [(r.first - r.due) * 1e3 for r in self.window_reqs() if r.first is not None]

    def token_gaps_ms(self) -> list[float]:
        """Every gap between consecutive output tokens of a request whose
        later token falls in the window."""
        out = []
        for r in self.reqs.values():
            s = sorted(r.stamps)
            out += [(b[1] - a[1]) * 1e3 for a, b in zip(s, s[1:]) if self.in_window(b[1])]
        return out

    def window_tokens(self) -> int:
        return sum(1 for r in self.reqs.values() for _, t in r.stamps if self.in_window(t))

    def step_ms(self, chunk: bool) -> list[float]:
        """Host times of the window's steps outside the profiled slice that
        ran a chunk call (``chunk``) or only decoded."""
        return [(s.t1 - s.t0) * 1e3 for s in self.steps
                if self.in_window(s.t0) and not s.profiled
                and ((s.chunk_rows > 0) if chunk else (s.chunk_rows == 0 and s.tokens_out > 0))]

    def attempted(self) -> int:
        if self.cell.mix["loop"] == "open":
            return len(self.window_reqs())
        # a closed loop: the requests in flight when the window opened too
        return sum(1 for r in self.reqs.values()
                   if r.due < self.t1 and (r.finish is None or r.finish >= self.t0))

    def failed(self) -> int:
        if self.cell.mix["loop"] == "open":
            return sum(1 for r in self.window_reqs() if r.first is None or r.rejected)
        return sum(1 for r in self.reqs.values() if r.rejected)


def port_config(conf: dict, arch: str | None = None):
    """The port's configuration of ``conf``, held to the file's numbers (a
    ``-smoke`` arch for the CPU tests is held to nothing)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch or conf["arch"])
    if arch is None:
        mapping = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.norm_eps,
                   "tie_word_embeddings": cfg.tie_embeddings,
                   "attention_bias": cfg.attn_bias}
        if conf.get("num_experts"):
            mapping.update(num_experts=cfg.num_experts,
                           num_experts_per_tok=cfg.experts_per_token,
                           moe_intermediate_size=cfg.moe_d_ff)
            if conf["assumed"]["capacity_factor"] != cfg.capacity_factor:
                raise ValueError(f"{conf['arch']}: capacity factor {cfg.capacity_factor}, "
                                 f"the file states {conf['assumed']['capacity_factor']}")
        else:
            mapping["intermediate_size"] = cfg.d_ff
        wrong = {k: (conf[k], v) for k, v in mapping.items() if conf[k] != v}
        if wrong:
            raise ValueError(f"{conf['arch']}: the port runs other sizes than the "
                             f"configuration's file states (file, port): {wrong}")
    return cfg


def smoke_conf(conf: dict, cfg) -> dict:
    """The configuration's file with the sizes of a ``-smoke`` arch."""
    out = dict(conf, hidden_size=cfg.d_model, num_hidden_layers=cfg.num_layers,
               num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, vocab_size=cfg.vocab_size,
               intermediate_size=cfg.d_ff)
    if conf.get("num_experts"):
        out.update(num_experts=cfg.num_experts, num_experts_per_tok=cfg.experts_per_token,
                   moe_intermediate_size=cfg.moe_d_ff)
    return out


def slice_done(steps: int, chunks: int, last_chunk: bool, min_steps: int) -> bool:
    """Whether a slice that has run ``steps`` steps, ``chunks`` of them with
    a chunk call, the last one such (``last_chunk``), closes: it ends on a
    chunk step once it holds ``SLICE_CHUNKS`` of them and ``min_steps``
    steps."""
    return last_chunk and chunks >= SLICE_CHUNKS and steps >= min_steps


class Driver:
    """Plays the server's event loop around one engine."""

    def __init__(self, engine, traffic: generator.Traffic, cell: spec.Cell,
                 conf: dict, traced: bool, cuda: bool):
        self.engine = engine
        self.traffic = traffic
        self.cell = cell
        self.conf = conf
        self.traced = traced
        self.cuda = cuda
        self.steps: list[StepRec] = []
        self.reqs: dict[int, ReqRec] = {}
        self.warm: dict[int, ReqRec] = {}
        self.next_rid = 0
        self.prof = None
        self.armed = False         # the slice opens after the next chunk step
        self.prof_chunks = 0
        self.prof_until = 0.0
        self.slice_steps: list[int] = []

    # ------------------------------------------------------------ requests
    def submit(self, item: generator.Item, due: float, warm: bool = False) -> ReqRec:
        from repro_torch.serving import Request, SamplingParams

        if warm:
            rid = WARM_RID + len(self.warm)
        else:
            rid, self.next_rid = self.next_rid, self.next_rid + 1
        req = Request(rid=rid, prompt=list(item.prompt),
                      sampling=SamplingParams(temperature=0.0, max_new_tokens=item.max_new))
        rec = ReqRec(rid, item, due, req)
        (self.warm if warm else self.reqs)[rid] = rec
        rec.rejected = not self.engine.submit(req, now=due)
        return rec

    def record(self, rid: int) -> ReqRec:
        return self.reqs.get(rid) or self.warm[rid]

    # ---------------------------------------------------------------- step
    def step(self) -> tuple[StepRec, list[int]]:
        """One engine step; returns its record and the ids finished in it."""
        from repro_torch.serving import FinishEvent, FirstTokenEvent, TokenEvent

        profiled = self.prof is not None
        t0 = time.perf_counter()
        if profiled:
            with torch.profiler.record_function(trace.STEP):
                st = self.engine.step(t0)
                torch.cuda.synchronize()
        else:
            st = self.engine.step(t0)
            if self.traced and self.cuda:
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        done, ctx = [], []
        for ev in st.events:
            if isinstance(ev, TokenEvent):
                rec = self.record(ev.rid)
                rec.stamps.append((ev.index, t1))
                if not isinstance(ev, FirstTokenEvent):
                    ctx.append(len(rec.item.prompt) + ev.index)
            elif isinstance(ev, FinishEvent):
                self.record(ev.rid).finish = t1
                done.append(ev.rid)
        rec = StepRec(t0, t1, st.chunk_rows, st.tokens_out, profiled, ctx)
        self.steps.append(rec)
        if profiled:
            self.slice_steps.append(len(self.steps) - 1)
            self.prof_chunks += rec.chunk_rows > 0
            if (slice_done(len(self.slice_steps), self.prof_chunks, rec.chunk_rows > 0,
                           self.cell.profile_steps) or t1 >= self.prof_until):
                self.stop_profile()
        elif self.armed and rec.chunk_rows > 0:
            self.armed = False
            self.start_profile()
        return rec, done

    # ------------------------------------------------------------- profile
    def start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=bool(self.conf.get("num_experts")))
        t = time.perf_counter()
        self.prof.__enter__()
        torch.cuda.synchronize()
        print(f"portbench: the profiler started in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        self.prof_until = time.perf_counter() + SLICE_MAX_S

    def stop_profile(self) -> None:
        self.prof.__exit__(None, None, None)
        self.done_prof, self.prof = self.prof, None

    # ------------------------------------------------------------- set-up
    def warm_up(self, seed: int) -> None:
        """Run every shape the window uses once."""
        vocab = self.engine.cfg.vocab_size
        rng = np.random.default_rng([seed % 2 ** 64, 3])
        heads = getattr(self.traffic, "prefixes", None)
        if heads is not None:
            items = [generator.Item(list(h) + rng.integers(0, vocab, 16).tolist(), 2)
                     for h in heads]
        else:
            items = [generator.Item(rng.integers(0, vocab, 64).tolist(), 3) for _ in range(2)]
        now = time.perf_counter()
        for it in items:
            self.submit(it, now, warm=True)
        while self.engine.pending():
            self.step()
        self.steps.clear()
        if self.traced and self.cuda:
            # the profiler's first start loads its device tracer, which
            # takes seconds: once here, not in the window
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def ramp(self) -> None:
        """A closed loop's first request per client; returns once each of
        them has its first token."""
        now = time.perf_counter()
        first = [self.submit(it, now) for it in self.traffic.initial]
        while any(r.first is None and not r.rejected for r in first):
            _, done = self.step()
            for _ in done:
                self.submit(self.traffic.next_item(), time.perf_counter())

    # -------------------------------------------------------------- window
    def window_open(self, t0: float, seconds: float, drain_s: float) -> tuple[int, int]:
        items = self.traffic.items
        due = [t0 + it.due for it in items]
        t1, t_mid = t0 + seconds, t0 + seconds / 2
        q_mid = q_end = None
        i = 0
        deadline = t1 + drain_s
        slice_at = t0 + SLICE_AT * seconds if self.traced and self.cuda else None
        while True:
            now = time.perf_counter()
            while i < len(items) and due[i] <= now:
                self.submit(items[i], due[i])
                i += 1
            if q_mid is None and now >= t_mid:
                q_mid = self.engine.scheduler.depth()
            if now >= t1:
                if q_end is None:
                    q_end = self.engine.scheduler.depth()
                    self.armed = False
                    if self.prof is not None:
                        self.stop_profile()
                waiting = any(r.first is None and not r.rejected for r in self.reqs.values())
                if not waiting or now >= deadline:
                    break
            if slice_at is not None and now >= slice_at and now < t1:
                slice_at = None
                self.armed = True
            if not self.engine.pending():
                nxt = due[i] if i < len(items) else t1
                if now < t1:
                    time.sleep(max(0.0, min(nxt, t1) - now))
                    continue
                break
            self.step()
        return q_mid or 0, q_end or 0

    def window_closed(self, t0: float, seconds: float) -> tuple[int, int]:
        t1, t_mid = t0 + seconds, t0 + seconds / 2
        q_mid = None
        slice_at = t0 + SLICE_AT * seconds if self.traced and self.cuda else None
        while True:
            now = time.perf_counter()
            if now >= t1:
                break
            if q_mid is None and now >= t_mid:
                q_mid = self.engine.scheduler.depth()
            if slice_at is not None and now >= slice_at:
                slice_at = None
                self.armed = True
            _, done = self.step()
            for _ in done:
                self.submit(self.traffic.next_item(), time.perf_counter())
        if self.prof is not None:
            self.stop_profile()
        return q_mid or 0, self.engine.scheduler.depth()


def run_cell(root, cell_name: str, seed: int, seconds: float, traced: bool, *,
             t_proc: float, device: str = "cuda", arch: str | None = None,
             engine_overrides: dict | None = None, mix_overrides: dict | None = None,
             limits: dict | None = None,
             control: bool = False, sabotage=None) -> tuple[dict, Run]:
    """One run; returns (the result's fields, the run's records).  ``arch``,
    the overrides and ``limits`` serve the CPU tests (a ``-smoke``
    arch at small sizes); ``control`` puts the precision control in the
    program's place in the check; ``sabotage(engine)`` breaks the timed path (the tests of
    the check)."""
    from repro_torch.configs.perf import PerfConfig
    from repro_torch.models.lm import make_model
    from repro_torch.serving import InferenceEngine

    cell = spec.load_cell(root, cell_name)
    if mix_overrides:
        cell.mix = {**cell.mix, **mix_overrides}
    conf = cell.conf
    cfg = port_config(conf, arch)
    if arch is not None:
        conf = smoke_conf(conf, cfg)
    eng_set = {**cell.engine, **(engine_overrides or {})}
    cuda = device.startswith("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dev = torch.device(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    perf = PerfConfig(use_kernels=eng_set["kernels"])
    params = weights.draw(make_model(cfg, perf).param_specs(), seed, dev)
    engine = InferenceEngine(
        cfg, params=params, capacity=eng_set["capacity"], max_len=eng_set["max_len"],
        perf=perf, buckets=(eng_set["chunk"],), kv_backend="paged",
        block_size=eng_set["block_size"], enable_prefix_cache=eng_set["prefix_cache"],
        seed=seed % 2 ** 62, device=dev)
    if not engine.paged:
        raise ValueError(f"{cfg.name}: the paged backend does not serve it")
    if traced:
        trace.instrument(engine)
    if sabotage is not None:
        sabotage(engine)
    traffic = generator.build(cell.mix, seed, seconds, cfg.vocab_size)
    drv = Driver(engine, traffic, cell, conf, traced, cuda)

    drv.warm_up(seed)
    if traffic.loop == "closed":
        drv.ramp()
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if traffic.loop == "open":
        q_mid, q_end = drv.window_open(t0, seconds, float(cell.mix.get("drain_s", DRAIN_S)))
    else:
        q_mid, q_end = drv.window_closed(t0, seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else None

    run = Run(cell=cell, conf=conf, seconds=seconds, traced=traced, setup_s=t0 - t_proc,
              t0=t0, t1=t0 + seconds, steps=drv.steps, reqs=drv.reqs,
              tracer=engine.tracer, queue_mid=q_mid, queue_end=q_end)
    prof = getattr(drv, "done_prof", None)
    if prof is not None:
        run.slice = trace.reduce(
            prof.events(), drv.slice_steps,
            prof.key_averages(group_by_input_shape=True) if conf.get("num_experts") else [],
            conf)
        kept = len(run.slice.steps) if run.slice else 0
        print(f"portbench: the profiled slice kept {kept} of its {len(drv.slice_steps)} steps",
              file=sys.stderr)
        del prof, drv.done_prof

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        if m.source == "device_trace" and not cuda:
            continue        # a CPU run reports no device metric
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    # free the program's state before the reference runs
    del engine, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = checks.check(run, params, conf, eng_set["chunk"], seed,
                           spec.reference(conf["family"]),
                           {**cell.check["limits"], **(limits or {})},
                           cell.check["requests"], cell.check["tokens"], control=control)
    del params
    gc.collect()

    result = {"correct": verdict["correct"], "attempted": run.attempted(),
              "failed": run.failed(), "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, "memory_peak_bytes": peak}
        if run.slice is not None:
            result["device"].update(busy_s=run.slice.busy_s, window_s=run.slice.wall_s)
            result["breakdown"] = {"device_ops": [list(x) for x in run.slice.device_ops],
                                   "idle_gaps": [list(x) for x in run.slice.idle_by_host]}
    if control:
        result["program_correct"] = verdict["program_correct"]
    result["checks"] = verdict["checks"]
    return result, run
