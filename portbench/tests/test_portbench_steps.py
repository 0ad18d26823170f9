"""The reader of the engine's step spans: on hand-made spans (which steps
it takes, by the ``now`` each was given), on a program that records none,
on the steps a profiler saw in a CPU engine, and on whole traced runs on
the CPU, where the card's numbers are absent."""
import types

import numpy as np
import pytest

from portbench.harness import runner, steps
from repro_torch.core.tracing import Span
from smoke import CHAT, MOE, run
from test_portbench_window import reader

NEW = ("decode_forward_idle_share",)


def decode(now, fwd):
    """One decode step's spans, its forward ``fwd`` seconds long."""
    phases = {"engine.admit": (now, now + 0.001),
              "engine.decode.forward": (now + 0.001, now + 0.001 + fwd),
              "engine.decode.wait": (now + 0.001 + fwd, now + 0.002 + fwd)}
    out = [Span(0, 0, "engine.step", now, now + 0.002 + fwd,
                attrs={"now": now, "kind": "decode"})]
    out += [Span(0, i + 1, name, a, b, parent_id=0)
            for i, (name, (a, b)) in enumerate(phases.items())]
    return out


def make_run(recorded=True, slice_idle=None):
    # steps at now 10, 11, 12 (profiled) and 13
    recs = [runner.StepRec(t, t + 0.05, 0, 4, t == 12.0, []) for t in (10.0, 11.0, 12.0, 13.0)]
    spans = [decode(10.0, 0.030), decode(11.0, 0.040), decode(12.0, 0.050), decode(13.0, 0.060)]
    tracer = types.SimpleNamespace(step_spans=lambda: spans) if recorded else object()
    r = runner.Run(cell=None, conf={}, seconds=10.0, traced=True, setup_s=1.0, t0=10.0,
                   t1=20.0, steps=recs, reqs={}, tracer=tracer)
    if slice_idle is not None:
        r.slice = types.SimpleNamespace(steps=[2], idle_by_host=slice_idle)
    return r


def test_the_idle_share_reads_the_slice_under_the_forward():
    read = reader("layer_metrics", "decode_forward_idle_share")
    assert read(make_run()) is None                   # no slice
    idle = [("model.decode_step_paged", 0.02), ("step", 0.01)]
    assert read(make_run(slice_idle=idle)) == pytest.approx(100 * 0.02 / 0.05)
    assert read(make_run(slice_idle=[("step", 0.01)])) == 0.0


def test_a_program_that_records_no_steps_reads_nothing():
    for r in (make_run(recorded=False), make_run(recorded=False, slice_idle=[("step", 1.0)])):
        assert all(reader("layer_metrics", name)(r) is None for name in NEW)


def test_the_reader_finds_the_steps_a_profiler_saw():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serving import InferenceEngine, Request, SamplingParams

    eng = InferenceEngine(get_config("qwen2-0.5b-smoke"), kv_backend="paged", capacity=4,
                          max_len=64, buckets=(16,), block_size=8, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(0, 100, 12)],
                           sampling=SamplingParams(max_new_tokens=8)), now=0.0)
    recs = []
    for k in range(7):
        profiled = 3 <= k < 6
        now = 10.0 + k
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                st = eng.step(now)
        else:
            st = eng.step(now)
        recs.append(runner.StepRec(now, now + 0.5, st.chunk_rows, st.tokens_out, profiled, []))
    r = runner.Run(cell=None, conf={}, seconds=10.0, traced=True, setup_s=1.0, t0=10.0,
                   t1=20.0, steps=recs, reqs={}, tracer=eng.tracer)
    assert [sp[0].attrs["now"] for sp in steps.recorded(r)] == [13.0, 14.0, 15.0]
    r.slice = types.SimpleNamespace(steps=[4, 5], idle_by_host=[("model.decode_step_paged", 1e-4)])
    fwd = [steps.phase(sp, steps.FORWARD) for sp in steps.sliced(r)]
    assert len(fwd) == 2 and all(f is not None and f.duration > 0 for f in fwd)
    got = reader("layer_metrics", "decode_forward_idle_share")(r)
    assert got == pytest.approx(100 * 1e-4 / sum(f.duration for f in fwd))


@pytest.mark.parametrize("cell", [CHAT, MOE])
def test_a_traced_cpu_run_records_no_steps_outside_a_profiler(cell):
    res, r = run(cell, trace=True)
    assert res["correct"] is True, res["checks"]
    assert "decode_forward_idle_share" not in res["metrics"]
    assert r.slice is None and steps.recorded(r) == []
