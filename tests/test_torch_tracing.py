"""The port's step spans (``repro_torch.core.tracing``) on the CPU: the off
path makes no range, event or span; on, each step's phases nest in its
``engine.step`` span in order, with ranges only while a profiler runs; a
profiler records the steps it sees with the switch off; the
step's counts, the stopwatch behind ``StepStats`` and
``engine_step_seconds``, the Chrome export, the model's ``lm.*`` ranges
under ``torch.profiler``, and CUDA-event resolution with a stand-in event
class."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tracing
from repro_torch.core.tracing import STEP_PHASES, STEPS_TID, Tracer
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "qwen2-0.5b-smoke"
MOE_ARCH = "qwen3-moe-30b-a3b-smoke"
# capacity 4, chunk 16: a chunk call computes 64 positions
KW = dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8, device="cpu")
PROMPTS = (5, 30, 11, 40)
# prompt tokens each chunk call advances, by hand: paged, every prompt in
# slices of 16; dense, the two prompts past the largest bucket (the others
# prefill bucketed at admission)
HAND = {"paged": [5 + 16 + 11 + 16, 14 + 16, 8], "dense": [16 + 16, 14 + 16, 8]}
ORDER = list(STEP_PHASES)


def _engine(backend, arch=ARCH, record=True):
    eng = InferenceEngine(get_config(arch), kv_backend=backend, **KW)
    eng.tracer.record_steps = record
    rng = np.random.default_rng(0)
    vocab = eng.cfg.vocab_size
    for i, n in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(0, vocab, n)],
                           sampling=SamplingParams(max_new_tokens=4)), now=float(i))
    return eng


def _drain(eng, t=10.0):
    while eng.pending():
        eng.step(now=t)
        t += 1.0
    return t


def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


class _Counter:
    """Counts ``record_function`` calls and their enters and exits."""

    def __init__(self, monkeypatch):
        self.calls = self.enters = self.exits = 0
        self.names = []
        real = torch.profiler.record_function
        counter = self

        class Counted(real):
            def __init__(self, name, *a, **k):
                counter.calls += 1
                counter.names.append(name)
                super().__init__(name, *a, **k)

            def __enter__(self):
                counter.enters += 1
                return super().__enter__()

            def __exit__(self, *exc):
                counter.exits += 1
                return super().__exit__(*exc)

        monkeypatch.setattr(torch.profiler, "record_function", Counted)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_recording_off_makes_no_range_event_or_span(backend, monkeypatch):
    counts = _Counter(monkeypatch)
    made = []
    real = tracing._StepRecorder
    monkeypatch.setattr(tracing, "_StepRecorder",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(2) or pytest.fail("an event"))
    eng = _engine(backend, record=False)
    _drain(eng)
    assert counts.calls == 0 and made == []
    assert eng.tracer.step_spans() == [] and eng.model.ranges is False
    assert eng.tracer.step_clock(0.0).recording is False
    # the stopwatch still runs
    assert all(st.prefill_s > 0 for st in eng.history if st.chunk_rows)
    assert all(st.decode_s > 0 for st in eng.history if st.tokens_out)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_phase_spans_nest_in_the_step_in_order(backend, monkeypatch):
    counts = _Counter(monkeypatch)
    eng = _engine(backend)
    with _profiled():
        _drain(eng)
    steps = eng.tracer.step_spans()
    assert len(steps) == len(eng.history)
    for spans, st in zip(steps, eng.history):
        step, kids = spans[0], spans[1:]
        assert step.name == "engine.step" and step.parent_id is None
        assert step.attrs["now"] == st.t and step.replica == eng._rlabel
        names = [s.name for s in kids]
        assert names == sorted(names, key=ORDER.index) and len(set(names)) == len(names)
        assert names[0] == "engine.admit" and names[-1] == "engine.emit"
        assert ("engine.chunk.forward" in names) == (st.chunk_rows > 0)
        assert ("engine.decode.wait" in names) == (st.tokens_out > 0)
        assert all(s.parent_id == 0 and s.trace_id == step.trace_id for s in kids)
        assert step.t0 <= kids[0].t0 and kids[-1].t1 <= step.t1
        for a, b in zip(kids, kids[1:]):
            assert a.t0 <= a.t1 <= b.t0
    # a range for every span, and the model's own; all closed
    n_spans = sum(len(s) for s in steps)
    assert counts.names.count("engine.step") == len(steps)
    assert counts.calls > n_spans and counts.enters == counts.exits == counts.calls
    assert {"lm.embed", "lm.slots", "lm.attention", "lm.mlp", "lm.logits"} <= set(counts.names)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_recording_outside_a_profiler_opens_no_range(backend, monkeypatch):
    counts = _Counter(monkeypatch)
    eng = _engine(backend)
    _drain(eng)
    assert counts.calls == 0 and eng.model.ranges is False
    steps = eng.tracer.step_spans()
    assert len(steps) == len(eng.history)
    assert all(s.t1 is not None for sp in steps for s in sp)
    # the profiler's start opens them from the next step on, its stop closes them
    eng = _engine(backend)
    eng.step(now=10.0)
    with _profiled():
        eng.step(now=11.0)
        assert eng.model.ranges is True
    calls = counts.calls
    assert calls > 0 and counts.enters == counts.exits == calls
    eng.step(now=12.0)
    assert counts.calls == calls and eng.model.ranges is False


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_step_counts_match_hand_counts(backend):
    eng = _engine(backend)
    _drain(eng)
    attrs = [sp[0].attrs for sp in eng.tracer.step_spans()]
    chunk = [a for a in attrs if a["kind"] == "chunk"]
    assert [a["tokens_valid"] for a in chunk] == HAND[backend]
    if backend == "paged":
        # the paged call computes the chunks of the rows it advances alone
        rows = {st.t: st.chunk_rows for st in eng.history}
        assert all(a["positions_computed"] == rows[a["now"]] * 16 for a in chunk)
        assert [a["positions_computed"] for a in chunk] == [4 * 16, 2 * 16, 16]
    else:
        assert all(a["positions_computed"] == 4 * 16 for a in chunk)
    assert all(a["positions_computed"] == a["tokens_valid"] == 0
               for a in attrs if a["kind"] == "decode")
    assert len(attrs) > len(chunk)
    if backend == "paged":
        assert sum(a["tokens_valid"] for a in attrs) == sum(PROMPTS)


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_step_stats_read_the_phase_host_times(backend):
    eng = _engine(backend)
    _drain(eng)
    pre = ("engine.admit", "engine.chunk.prepare", "engine.chunk.forward",
           "engine.chunk.sample")
    for spans, st in zip(eng.tracer.step_spans(), eng.history):
        dur = {s.name: s.duration for s in spans[1:]}
        assert st.prefill_s == pytest.approx(sum(dur.get(n, 0.0) for n in pre), rel=1e-9)
        assert st.decode_s == pytest.approx(
            sum(v for n, v in dur.items() if n.startswith("engine.decode.")), rel=1e-9)
    text = eng.metrics.render()
    for phase in ("admit", "chunk", "decode", "sample", "emit"):
        assert f'engine_step_seconds_count{{replica="0",phase="{phase}"}}' in text
    n = len(eng.history)
    assert f'engine_step_seconds_count{{replica="0",phase="admit"}} {n}' in text


def test_chrome_trace_carries_the_steps_track():
    eng = _engine("paged")
    _drain(eng)
    doc = json.loads(json.dumps(eng.tracer.chrome_trace()))
    ev = doc["traceEvents"]
    steps = [e for e in ev if e["ph"] == "X" and e["tid"] == STEPS_TID]
    assert {e["name"] for e in steps} >= {"engine.step", "engine.admit",
                                          "engine.chunk.forward", "engine.decode.wait"}
    assert all(e["cat"] == "step" and e["pid"] == 0 for e in steps)
    tops = [e for e in steps if e["name"] == "engine.step"]
    assert len(tops) == len(eng.history)
    assert all(e["args"]["kind"] in ("chunk", "decode") for e in tops)
    assert {"name": "thread_name", "ph": "M", "pid": 0, "tid": STEPS_TID,
            "args": {"name": "steps"}} in ev
    assert any(e["ph"] == "X" and e["tid"] == 0 and e["name"] == "request" for e in ev)


@pytest.mark.parametrize("arch,mlp", [(ARCH, "lm.mlp"), (MOE_ARCH, "lm.moe")])
def test_model_ranges_nest_in_the_decode_forward(arch, mlp):
    from torch.profiler import ProfilerActivity, profile

    eng = _engine("paged", arch=arch)
    t = 10.0
    while not eng.row_req:
        eng.step(now=t)
        t += 1.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(now=t)
    ev = prof.events()
    fwd = [e.time_range for e in ev if e.name == "engine.decode.forward"]
    assert len(fwd) == 1
    inside = [e.name for e in ev
              if fwd[0].start <= e.time_range.start and e.time_range.end <= fwd[0].end]
    n_layers = eng.cfg.num_layers
    assert inside.count("lm.attention") == n_layers
    assert inside.count(mlp) == n_layers
    assert {"lm.embed", "lm.slots", "lm.logits"} <= set(inside)
    outer = {e.name for e in ev}
    assert {"engine.step", "engine.decode.sample", "engine.decode.wait"} <= outer


def test_switching_recording_off_again_stops_the_ranges(monkeypatch):
    counts = _Counter(monkeypatch)
    eng = _engine("paged")
    with _profiled():
        eng.step(now=10.0)
        assert eng.model.ranges is True and counts.calls > 0
    eng.tracer.record_steps = False
    calls = counts.calls
    _drain(eng, 11.0)
    assert counts.calls == calls and eng.model.ranges is False
    assert len(eng.tracer.step_spans()) == 1


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_a_profiler_records_the_steps_it_sees(backend, monkeypatch):
    counts = _Counter(monkeypatch)
    eng = _engine(backend, record=False)
    eng.step(now=10.0)
    assert eng.tracer.step_spans() == [] and counts.calls == 0
    with _profiled():
        eng.step(now=11.0)
        eng.step(now=12.0)
        assert eng.model.ranges is True
    calls = counts.calls
    assert calls > 0 and counts.enters == counts.exits == calls
    _drain(eng, 13.0)
    assert counts.calls == calls and eng.model.ranges is False
    kept = eng.tracer.step_spans()
    assert [sp[0].attrs["now"] for sp in kept] == [11.0, 12.0]
    assert all(s.t1 is not None for sp in kept for s in sp)
    assert counts.names.count("engine.step") == 2


def test_the_ring_keeps_the_last_steps(monkeypatch):
    monkeypatch.setattr(Tracer, "step_capacity", 3)
    eng = _engine("paged")
    _drain(eng)
    kept = eng.tracer.step_spans()
    assert len(kept) == 3 < len(eng.history)
    assert [sp[0].attrs["now"] for sp in kept] == [st.t for st in eng.history[-3:]]


def test_a_step_that_raises_closes_its_ranges(monkeypatch):
    counts = _Counter(monkeypatch)
    eng = _engine("paged")

    def boom(*a, **k):
        raise RuntimeError("forward failed")

    eng.model.prefill_chunk_paged = boom
    with _profiled(), pytest.raises(RuntimeError, match="forward failed"):
        eng.step(now=10.0)
    assert counts.enters == counts.exits > 0
    assert eng.tracer.step_spans() == []


def test_request_traces_stay_whole_beside_the_steps():
    eng = _engine("paged")
    _drain(eng)
    assert eng.tracer.verify() == []
    for rid in range(len(PROMPTS)):
        assert eng.tracer.gaps(rid) == []
        names = [s.name for s in eng.tracer.spans(rid)]
        assert names[:2] == ["request", "queue_wait"] and "decode" in names


def test_chunk_numbers_count_on_the_trace():
    eng = _engine("paged")
    _drain(eng)
    for rid, n in enumerate(PROMPTS):
        tr = next(t for t in eng.tracer.traces() if t.rid == rid)
        chunks = [s for s in tr.spans if s.name.startswith("prefill_chunk[")]
        assert [s.name for s in chunks] == [f"prefill_chunk[{k}]"
                                            for k in range(-(-n // 16))]
        assert [s.attrs["pos0"] for s in chunks] == list(range(0, n, 16))
        assert sum(s.attrs["tokens"] for s in chunks) == n
    assert eng.tracer.annotate_chunk(999, 0.0) is None


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: a clock value at ``record`` and
    a flag for whether the device has passed it."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t, self.done = None, False

    def record(self):
        self.t = float(_FakeEvent.made)
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return (end.t - self.t) * 10.0


def test_device_times_resolve_once_the_device_passed_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    tr = Tracer()
    tr.record_steps = True
    m0 = _FakeEvent.made
    clock = tr.step_clock(1.0, "0", cuda=True)
    clock.enter("engine.admit")
    clock.enter("engine.chunk.forward", device=True)
    clock.leave()
    clock.enter("engine.chunk.sample", device=True)
    clock.end_device()                  # the launch's end, before the wait
    made = _FakeEvent.made
    clock.enter("engine.decode.forward")
    clock.enter("engine.decode.sample", device=True)
    clock.enter("engine.decode.wait")
    clock.enter("engine.emit")
    clock.finish(kind="chunk", positions_computed=0, tokens_valid=0)
    assert made - m0 == 4 and _FakeEvent.made - m0 == 6
    (spans,) = tr.step_spans()
    dev = {s.name: s.attrs.get("device_ms", "none") for s in spans[1:]}
    assert dev == {"engine.admit": "none", "engine.chunk.forward": None,
                   "engine.chunk.sample": None, "engine.decode.forward": "none",
                   "engine.decode.sample": None, "engine.decode.wait": "none",
                   "engine.emit": "none"}
    pending = list(tr._pending)
    assert [sp.name for sp, _, _ in pending] == ["engine.chunk.forward",
                                                 "engine.chunk.sample",
                                                 "engine.decode.sample"]
    pending[0][1].done = pending[0][2].done = True      # the forward's pair
    tr.step_spans()
    assert spans[2].attrs["device_ms"] == pytest.approx(10.0)
    assert spans[3].attrs["device_ms"] is None
    for _, e0, e1 in pending:
        e0.done = e1.done = True
    tr.step_spans()
    # the sampler's pair: its start and the mark at the launch's end
    assert spans[3].attrs["device_ms"] == pytest.approx(10.0)
    assert spans[5].attrs["device_ms"] == pytest.approx(10.0)
    assert tr._pending == []
    # off the device, no event
    made = _FakeEvent.made
    clock = tr.step_clock(2.0, "0", cuda=False)
    clock.enter("engine.decode.forward", device=True)
    clock.finish(kind="decode", positions_computed=0, tokens_valid=0)
    assert _FakeEvent.made == made and "device_ms" not in tr.step_spans()[-1][1].attrs


def test_the_launcher_writes_the_steps_beside_the_requests(tmp_path):
    from repro_torch.launch import serve

    out = tmp_path / "trace.json"
    assert serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--requests", "4",
                       "--trace-out", str(out)]) == 0
    ev = json.loads(out.read_text())["traceEvents"]
    assert any(e.get("tid") == STEPS_TID and e["name"] == "engine.step" for e in ev)
    assert any(e["ph"] == "X" and e["name"] == "request" for e in ev)
