"""The window and drain accounting of a run, on hand-made records."""
import types

import pytest

from portbench.harness import runner, spec
from portbench.traffic.generator import Item
from smoke import ROOT


def reader(folder, name):
    return spec.load_module(ROOT / "portbench" / folder / f"{name}.py").read


def rec(rid, due, stamps, finish=None, prompt=10, rejected=False):
    r = runner.ReqRec(rid, Item([1] * prompt, 5), due, req=None)
    r.stamps = list(stamps)
    r.finish = finish
    r.rejected = rejected
    return r


def make_run(loop="open"):
    cell = types.SimpleNamespace(mix={"loop": loop})
    reqs = {
        0: rec(0, 9.0, [(0, 10.5), (1, 10.6), (2, 11.0)], finish=11.0),   # due before
        1: rec(1, 10.0, [(0, 10.4), (1, 10.9), (2, 19.5), (3, 20.5)]),    # last after
        2: rec(2, 15.0, [(0, 15.8), (1, 16.0)]),
        3: rec(3, 19.9, []),                                              # no first token
        4: rec(4, 20.0, [(0, 20.1)]),                                     # due at the close
    }
    steps = [runner.StepRec(10.0, 10.4, 1, 1, False, []),
             runner.StepRec(10.4, 10.45, 0, 2, False, [11, 12]),
             runner.StepRec(10.5, 10.55, 0, 2, True, [11, 12]),
             runner.StepRec(19.9, 20.4, 1, 0, False, [])]
    return runner.Run(cell=cell, conf={}, seconds=10.0, traced=False, setup_s=3.5,
                      t0=10.0, t1=20.0, steps=steps, reqs=reqs, tracer=None)


def test_ttft_counts_requests_due_in_the_window():
    run = make_run()
    assert [r.rid for r in run.window_reqs()] == [1, 2, 3]
    assert sorted(run.ttft_ms()) == pytest.approx([400.0, 800.0])
    assert run.failed() == 1 and run.attempted() == 3


def test_token_gaps_whose_later_token_falls_in_the_window():
    gaps = sorted(make_run().token_gaps_ms())
    # rid 0: 100, 400; rid 1: 500, 8600 (the 20.5 token is past the close); rid 2: 200
    assert gaps == pytest.approx([100.0, 200.0, 400.0, 500.0, 8600.0])


def test_output_tokens_in_the_window():
    run = make_run()
    assert run.window_tokens() == 8
    assert reader("end_to_end", "output_tokens_per_s")(run) == pytest.approx(0.8)
    assert reader("end_to_end", "setup_s")(run) == 3.5
    assert reader("end_to_end", "ttft_p90_ms")(run) == pytest.approx(760.0)


def test_step_times_leave_out_the_profiled_slice():
    run = make_run()
    assert run.step_ms(chunk=True) == pytest.approx([400.0, 500.0])
    assert run.step_ms(chunk=False) == pytest.approx([50.0])


def test_closed_loop_counts_requests_in_flight_at_the_open():
    run = make_run("closed")
    assert run.attempted() == 4       # rid 0 finished in the window; rid 4 due at the close
    assert run.failed() == 0


def slice_length(flags, steps):
    """Steps a slice runs over a stream of steps (True: a chunk call)."""
    n = c = 0
    for chunk in flags:
        n, c = n + 1, c + chunk
        if runner.slice_done(n, c, chunk, steps):
            return n
    return None


@pytest.mark.parametrize("flags,steps,want", [
    (([False] * 4 + [True]) * 4, 8, 15),                     # three whole periods
    (([False] * 1 + [True]) * 6, 8, 8),                      # ... at least the steps
    ([True] * 12, 8, 8),                                     # every step a chunk step
    ([False] * 12 + [True] + [False] * 20, 8, None),         # never closes off a period
])
def test_the_profiled_slice_ends_on_a_chunk_step(flags, steps, want):
    assert runner.SLICE_CHUNKS == 3
    assert slice_length(flags, steps) == want
