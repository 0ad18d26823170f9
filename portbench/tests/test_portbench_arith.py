"""The profiled slice's reduction and the step_mfu and roofline arithmetic
on hand-made records."""
import types

import pytest

from portbench.harness import peaks, runner, trace, work
from test_portbench_window import reader

CONF = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 4, "intermediate_size": 16, "num_hidden_layers": 3,
        "vocab_size": 10}


def ev(name, a, b, dev):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_type="DeviceType.CUDA" if dev else "DeviceType.CPU")


def test_reduce_takes_the_union_of_device_activity():
    events = [ev("step", 0, 600, False), ev("step", 0, 400, True),
              ev("_sample", 500, 600, False), ev("step", 850, 1000, False),
              ev("k1", 100, 300, True), ev("k2", 200, 400, True),
              ev("paged_decode_kernel", 700, 800, True), ev("k1", 950, 1200, True)]
    sl = trace.reduce(events, [4, 5, 6], [], CONF)
    assert sl.steps == [5, 6]          # the trace kept two of the three steps
    assert sl.wall_s == pytest.approx(1e-3)
    assert sl.busy_s == pytest.approx(450e-6)        # 100-400, 700-800, 950-1000
    assert dict(sl.device_ops)["k1"] == pytest.approx(250e-6)
    idle = dict(sl.idle_by_host)
    # gaps 0-100 and 400-500 (in step), 500-600 (in _sample), 600-700 and
    # 800-850 (outside a step), 850-950 (in the second step)
    assert idle["step"] == pytest.approx(300e-6)
    assert idle["_sample"] == pytest.approx(100e-6)
    assert idle[trace.OUTSIDE] == pytest.approx(150e-6)
    assert sl.expert_bmm_s is None


def slice_run(kernel_s, wall_s=1.0):
    steps = [runner.StepRec(1.0, 1.1, 0, 2, True, [5, 9]),
             runner.StepRec(2.0, 2.3, 1, 0, True, [])]
    span = types.SimpleNamespace(name="prefill_chunk[0]", t0=2.0,
                                 attrs={"pos0": 4, "tokens": 3})
    tracer = types.SimpleNamespace(traces=lambda: [types.SimpleNamespace(rid=0, spans=[span])])
    sl = trace.Slice(steps=[0, 1], wall_s=wall_s, busy_s=0.25, device_ops=[],
                     idle_by_host=[], kernel_s=kernel_s, expert_bmm_s=None)
    return runner.Run(cell=None, conf=CONF, seconds=10, traced=True, setup_s=0,
                      t0=0, t1=10, steps=steps, reqs={}, tracer=tracer, slice=sl)


def test_step_mfu_counts_computed_tokens_and_their_contexts():
    n = work.matmul_params(CONF)
    assert n == 3 * (8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16) + 8 * 10
    flops = sum(2 * n + 4 * c * 2 * 4 * 3 for c in (5, 9, 5, 6, 7))
    got = reader("layer_metrics", "step_mfu")(slice_run({}, wall_s=2.0))
    assert got == pytest.approx(100 * flops / (2.0 * peaks.PEAK_FLOPS_BF16))


def test_paged_roofline_is_the_bound_over_the_kernel_time():
    nbytes = 3 * (2 * 14 * 1 * 4 * 2 + 2 * 2 * 2 * 4 * 2)
    assert work.paged_attention_work(CONF, [5, 9]) == (nbytes, 4.0 * 14 * 2 * 4 * 3)
    run = slice_run({"paged_decode_kernel<64>": 2e-6, "other": 1.0})
    assert reader("layer_metrics", "paged_attention_roofline")(run) == pytest.approx(
        100 * (nbytes / peaks.HBM_BYTES_PER_S) / 2e-6)
    assert reader("layer_metrics", "paged_attention_roofline")(slice_run({})) is None


def test_idle_share_and_moe_reader():
    run = slice_run({})
    assert reader("layer_metrics", "device_idle_share")(run) == pytest.approx(75.0)
    assert reader("layer_metrics", "moe_expert_ms.per_step")(run) is None
    run.slice.expert_bmm_s = 0.03
    assert reader("layer_metrics", "moe_expert_ms.per_step")(run) == pytest.approx(15.0)


def test_expert_products_are_told_by_their_weight_shapes():
    conf = dict(CONF, num_experts=4, moe_intermediate_size=6)
    rows = [types.SimpleNamespace(key="aten::bmm", input_shapes=[[4, 7, 8], [4, 8, 6]],
                                  device_time_total=10.0),
            types.SimpleNamespace(key="aten::bmm", input_shapes=[[4, 7, 6], [4, 6, 8]],
                                  device_time_total=5.0),
            types.SimpleNamespace(key="aten::bmm", input_shapes=[[16, 7, 4], [16, 4, 9]],
                                  device_time_total=99.0),
            types.SimpleNamespace(key="aten::mm", input_shapes=[[7, 8], [8, 4]],
                                  device_time_total=50.0)]
    assert trace.expert_bmm_s(rows, conf) == pytest.approx(15e-6)
