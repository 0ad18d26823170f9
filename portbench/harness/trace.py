"""The traced run's profiler slice: a bounded run of steps in the middle
of the window under ``torch.profiler``, reduced to what the per-layer
readers need.

The host's ranges are ``record_function`` ranges the harness puts around
its own calls into each layer (``step``) and around the engine's calls
into the model, the sampler and the scheduler, by wrapping those methods
on the one engine instance; nothing inside ``repro_torch`` changes.
Device rows are summed from the device's own entries only: a host op's
self device time repeats its kernels' time."""
from __future__ import annotations

import dataclasses

import torch

from portbench.harness import stats

STEP = "step"
# (object path on the engine, method, label)
WRAPPED = (("model", "prefill_chunk_paged", "model.prefill_chunk_paged"),
           ("model", "decode_step_paged", "model.decode_step_paged"),
           ("", "_sample", "_sample"),
           ("scheduler", "next_batch", "scheduler.next_batch"))
LABELS = (STEP,) + tuple(w[2] for w in WRAPPED)
OUTSIDE = "harness loop"
TOP = 10
NAME_CHARS = 120            # a device op's name in the breakdown, cut to this


def _ranged(fn, label):
    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return call


def instrument(engine) -> None:
    """Put the host ranges around the engine instance's calls."""
    for path, name, label in WRAPPED:
        obj = getattr(engine, path) if path else engine
        setattr(obj, name, _ranged(getattr(obj, name), label))


def dev_us(e) -> float:
    """Device time (us) of a profiler row (``chip_smoke.dev_us``)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def on_device(e) -> bool:
    """Whether a profiler row is the device's own, a kernel or a copy, not a
    host op that launched one (``chip_smoke.on_device``)."""
    return str(e.device_type).endswith("CUDA")


@dataclasses.dataclass
class Slice:
    steps: list[int]                 # indices of the step records it covers
    wall_s: float                    # the slice's length on the host
    busy_s: float                    # union of device activity in it
    device_ops: list[tuple[str, float]]   # seconds by device op, most first
    idle_by_host: list[tuple[str, float]]  # idle seconds by the host's range
    kernel_s: dict[str, float]       # seconds of device ops by name
    expert_bmm_s: float | None       # device seconds of the MoE's expert products


def expert_bmm_s(key_avgs_by_shape, conf: dict) -> float | None:
    """Device seconds of ``aten::bmm`` calls on expert weights, (E, D, F) or
    (E, F, D): the op selection of ``chip_smoke.moe_step_report``, with the
    attention's own batched products told apart by their shapes."""
    E = conf.get("num_experts")
    if not E:
        return None
    D, F = conf["hidden_size"], conf["moe_intermediate_size"]
    us = 0.0
    for e in key_avgs_by_shape:
        if e.key != "aten::bmm":
            continue
        shapes = e.input_shapes or []
        if len(shapes) > 1 and list(shapes[1]) in ([E, D, F], [E, F, D]):
            us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return us / 1e6


def annotation(e) -> bool:
    """A ``record_function`` range's own row on the device's timeline: it
    spans the range's kernels and is no operation of its own."""
    return e.name in LABELS or bool(getattr(e, "is_user_annotation", False))


def reduce(events, steps: list[int], key_avgs_by_shape, conf: dict) -> Slice | None:
    """Reduce the profiler's events of one slice: from the start of its
    first ``step`` range on the host to the end of its last, each range
    ending in a synchronise.  Where the trace kept fewer step ranges than
    the slice ran, the slice is its last steps that it kept."""
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == STEP and not on_device(e))
    if not ranges:
        return None
    steps = steps[len(steps) - len(ranges):]
    lo, hi = ranges[0][0], ranges[-1][1]
    dev = [e for e in events if on_device(e) and not annotation(e)]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_us = stats.covered(intervals, lo, hi)
    by_name: dict[str, float] = {}
    for e in dev:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.name in LABELS and not on_device(e)]
    idle: dict[str, float] = {}
    for a, b in stats.gaps(intervals, lo, hi):
        # split the gap where a host range starts or ends; each piece goes
        # to the innermost range around it
        cuts = sorted({a, b} | {t for h0, h1, _ in host for t in (h0, h1) if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            inside = [(h1 - h0, name) for h0, h1, name in host if h0 <= mid <= h1]
            label = min(inside)[1] if inside else OUTSIDE
            idle[label] = idle.get(label, 0.0) + (y - x) / 1e6
    ops = sorted(((name[:NAME_CHARS], t) for name, t in by_name.items()),
                 key=lambda kv: -kv[1])
    return Slice(steps=steps, wall_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                 device_ops=ops[:TOP],
                 idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
                 kernel_s=by_name,
                 expert_bmm_s=expert_bmm_s(key_avgs_by_shape, conf))
