"""The port's cluster simulator (``repro_torch.core.cluster``) against the
reference's, bit for bit, on the scenarios of ``tests/test_sim_cluster.py``:
the paper's Fig. 4 at batch 62 with and without the HPA, Fig. 3's hotspot
run, failure injection, a straggler and open-loop Poisson arrivals.

Each scenario is one function of the cluster module (and its autoscaler),
run once through each package; the reference's Fig. 3 and Fig. 4 runs are
also held to what ``benchmarks/fig{3,4}_*.py`` report, so the lines driven
here are the benches' own.  Every finished job's end-to-end time and
per-stage latencies, the completion order, the replica counts and every
stage's ``stage_latency_stats`` must be equal as floats, not close.
"""
import pytest

import repro.core.autoscaler as JA
import repro.core.cluster as JC
import repro_torch.core.autoscaler as TA
import repro_torch.core.cluster as TC
from benchmarks.fig3_bottleneck import run as fig3_run
from benchmarks.fig4_autoscaling import WARMUP_S
from benchmarks.fig4_autoscaling import run_one as fig4_run_one

PACKAGES = {"reference": (JC, JA), "port": (TC, TA)}


def _fig4(C, A, batch, autoscale, duration_s=600.0):
    """``benchmarks/fig4_autoscaling.run_one``'s lines."""
    hpa = A.HPAConfig(metric="latency", target=2.0, min_replicas=1,
                      max_replicas=3, stabilization_s=30.0) if autoscale else None
    cl = C.SimCluster(C.ClusterConfig(seed=1), C.llama2_13b_a100_costs(), hpa=hpa,
                      hpa_targets=[27])
    C.closed_loop(cl, users=1, batch=batch, duration_s=duration_s, seed=2)
    return cl


def _fig3(C, A, duration_s=1200.0, seed=3):
    """``benchmarks/fig3_bottleneck.run``'s lines."""
    cl = C.SimCluster(C.ClusterConfig(seed=seed), C.llama2_13b_a100_costs(), hpa=None)
    C.poisson_open_loop(cl, rate_jobs_s=0.06, batch=32, duration_s=duration_s, seed=seed)
    return cl


def _failure(C, A):
    cl = C.SimCluster(C.ClusterConfig(num_layers=1, cold_start_s=0.0, seed=0),
                      [C.LayerCost(alpha=0.5, beta=0.0)])
    cl.services[0].scale_to(0.0, 2)
    cl.inject_failure(0.1, 0, 0)
    cl.submit(C.SimJob(0, 1, 10, t_submit=1.0))
    cl.run(until=10.0)
    return cl


def _straggler(C, A):
    cl = C.SimCluster(C.ClusterConfig(num_layers=1, cold_start_s=0.0, seed=0),
                      [C.LayerCost(alpha=1.0, beta=0.0)])
    cl.inject_straggler(0.0, 0, 0, speed=0.25)
    cl.submit(C.SimJob(0, 1, 10, t_submit=1.0))
    cl.run(until=20.0)
    return cl


def _poisson(C, A):
    cl = C.SimCluster(C.ClusterConfig(num_layers=2, seed=0),
                      [C.LayerCost(alpha=0.01, beta=0.0) for _ in range(2)])
    C.poisson_open_loop(cl, rate_jobs_s=5.0, batch=4, duration_s=30.0, seed=1)
    return cl


def _poisson_hpa(C, A):
    """Open loop at the hotspot's saturation, with the HPA on its service,
    heavy-tailed interference and the batch split across new replicas."""
    hpa = A.HPAConfig(metric="latency", target=2.0, max_replicas=3, stabilization_s=30.0)
    cl = C.SimCluster(C.ClusterConfig(seed=5), C.llama2_13b_a100_costs(), hpa=hpa,
                      hpa_targets=[27])
    C.poisson_open_loop(cl, rate_jobs_s=0.2, batch=32, duration_s=600.0, seed=5)
    return cl


SCENARIOS = {"fig4_b62": lambda C, A: _fig4(C, A, 62, False),
             "fig4_b62_hpa": lambda C, A: _fig4(C, A, 62, True),
             "fig3_1200s": _fig3, "failure": _failure, "straggler": _straggler,
             "poisson": _poisson, "poisson_hpa": _poisson_hpa}


def _record(cl) -> dict:
    names = sorted({n for j in cl.done for n in j.stage_latency})
    return {"done": [(j.jid, j.batch, j.tokens, j.t_submit, j.t_done, j.e2e,
                      sorted(j.stage_latency.items())) for j in cl.done],
            "stats": {n: cl.stage_latency_stats(n) for n in names},
            "stats_after_warmup": {n: cl.stage_latency_stats(n, t0=WARMUP_S)
                                   for n in names},
            "replicas": [len(s.replicas) for s in cl.services],
            "now": cl.now, "qps": cl.qps(), "mean_e2e": cl.mean_e2e()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sim_cluster_matches_reference_bit_for_bit(name):
    ref, got = (_record(SCENARIOS[name](*PACKAGES[k])) for k in ("reference", "port"))
    assert ref["done"], name
    assert got == ref


def test_fig4_scenario_is_the_bench_and_reproduces_the_paper():
    """The port's Fig. 4 lines give what the reference bench reports, and
    the paper's numbers at batch 62 within 5 %."""
    for autoscale, (e2e, qps) in ((False, (15.23, 4.07)), (True, (12.28, 5.05))):
        bench = fig4_run_one(62, autoscale, duration_s=600.0)
        cl = _fig4(TC, TA, 62, autoscale)
        got = cl.mean_e2e(t0=WARMUP_S)
        assert got == bench["e2e_s"]
        assert cl.stage_latency_stats("layer/27", t0=WARMUP_S)["mean"] == bench["layer27_s"]
        assert len(cl.services[27].replicas) == bench["replicas27"]
        assert got == pytest.approx(e2e, rel=0.05)
        assert 62 / got == pytest.approx(qps, rel=0.05)


def test_fig3_scenario_is_the_bench_and_exceeds_230x():
    bench = fig3_run(duration_s=1200.0, verbose=False)
    cl = _fig3(TC, TA)
    mx = {i: cl.stage_latency_stats(f"layer/{i}")["max"] for i in range(len(cl.services))}
    assert mx == bench["max_by_layer"] and len(cl.done) == bench["jobs"]
    assert mx[27] / mx[30] > 230.0
