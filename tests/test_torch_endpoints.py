"""The port's endpoint registry and serve launcher, on the CPU.

Two endpoints behind one registry — tenants with weighted-fair admission
and an in-flight quota, a shared transport, a scale-to-zero endpoint that
cold-starts twice — run once per package on the same logical clock, with
replicas built on the reference's f32 weights (``from_jax``): outputs,
rejections, endpoint states, replica counts and the cold-start and quota
counters must be equal.  Then the default engine factory on the CPU, and
``python -m repro_torch.launch.serve`` as a user runs it.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.configs import get_config
from repro_torch.core.endpoints import EndpointRegistry, ModelEndpoint
from repro_torch.models.params import from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams, State
from repro_torch.serving.scheduler import SchedulerConfig

ARCH = "qwen2-0.5b-smoke"
REPO = Path(__file__).resolve().parents[1]
KW = dict(capacity=2, max_len=64, buckets=(8, 16), block_size=8, seed=0)


def _settled(eng):
    """The reference engine, made to wait for its device work at the end of
    every step.  It hands its host block table to an asynchronous JAX call
    and edits the table in place afterwards (a chunk step that samples no
    token never waits), and on the CPU ``jnp.asarray`` may read the numpy
    buffer only when the call runs: under load, a row extracted right after
    such a step can lose that chunk's KV.  Waiting removes the race and
    changes nothing the engine computes."""
    step = eng.step

    def settled_step(now=None):
        st = step(now)
        jax.block_until_ready(eng.caches)
        return st

    eng.step = settled_step
    return eng


@pytest.fixture(scope="module")
def makers():
    """Per package: an engine factory on one shared f32 weight tree, and
    the package's request types."""
    jcfg = jax_get_config(ARCH)
    raw = JP.init(jax.random.PRNGKey(0), jax_make_model(jcfg).param_specs())
    np32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), raw)
    jp = jax.tree.map(jnp.asarray, np32)
    tp = from_jax(np32, get_config(ARCH))

    def jmake(backend, sched):
        return lambda: _settled(JEngine(jcfg, params=jp, kv_backend=backend,
                                        sched=dataclasses.replace(sched), **KW))

    def tmake(backend, sched):
        return lambda: InferenceEngine(get_config(ARCH), params=tp,
                                       kv_backend=backend, device="cpu",
                                       sched=dataclasses.replace(sched), **KW)

    return {"repro": (jmake, JRequest, JSamplingParams, JSchedulerConfig),
            "repro_torch": (tmake, Request, SamplingParams, SchedulerConfig)}


def _registry_run(pkg, makers):
    make, Req, SP, Sched = makers[pkg]
    ep = importlib.import_module(f"{pkg}.core.endpoints")
    A = importlib.import_module(f"{pkg}.core.autoscaler")
    T = importlib.import_module(f"{pkg}.core.transport")
    wfq = Sched(policy="wfq", max_prefill_per_step=2,
                tenant_weights={"gold": 3.0, "free": 1.0})
    reg = ep.EndpointRegistry(
        [ep.ModelEndpoint(
            name="base", make_engine=make("dense", wfq), max_replicas=2,
            cold_start_steps=1, control_every_steps=2,
            hpa=A.HPAConfig(metric="queue", target=2.0, max_replicas=2,
                            tolerance=0.0, stabilization_s=2.0,
                            scale_down_cooldown_s=2.0)),
         ep.ModelEndpoint(
             name="z", make_engine=make("paged", Sched()), min_replicas=0,
             max_replicas=1, cold_start_steps=3, idle_ticks_to_zero=2,
             control_every_steps=2)],
        transport=T.Transport(T.LinkSpec(latency_steps=1, bandwidth=4096)),
        tenants={"gold": ep.TenantQuota(weight=3.0),
                 "free": ep.TenantQuota(weight=1.0, max_inflight=3)})
    rng = np.random.default_rng(2)

    def req(rid, model, tenant, n):
        return Req(rid=rid, model=model, tenant=tenant,
                   prompt=[int(x) for x in rng.integers(0, 500, n)],
                   sampling=SP(max_new_tokens=5))

    arrivals = {0.0: [req(i, "base", ("gold", "free")[i % 2], 6 + 3 * i)
                      for i in range(9)] + [req(20, "z", None, 10)],
                1.0: [req(21, "z", "gold", 20)],
                40.0: [req(30, "z", "free", 12), req(31, "base", "free", 9)]}
    accepted, states, t = {}, [], 0.0
    while t < 300:
        for r in arrivals.get(t, []):
            accepted[r.rid] = reg.submit(r, now=t)
        if not reg.pending() and t > max(arrivals):
            break
        reg.step(t)
        states.append((reg.state("base"), reg.state("z"),
                       reg.total_replicas()))
        t += 1.0
    m = reg.metrics
    return dict(
        accepted=accepted, states=states,
        outputs={r.rid: list(r.output) for r in reg.finished()},
        rejected=sorted(r.rid for rs in arrivals.values() for r in rs
                        if r.state.name == "REJECTED"),
        cold=[m.get("endpoint_cold_starts_total").value(endpoint="z"),
              m.get("endpoint_cold_start_steps").value(endpoint="z")],
        quota=m.get("tenant_rejections_total").value(tenant="free",
                                                     reason="quota"),
        scale={n: reg.resolve(n).scale_history for n in reg.names()},
        models=[dataclasses.asdict(x) for x in importlib.import_module(
            f"{pkg}.serving").ModelsAPI(reg).list().data])


def test_registry_matches_reference(makers):
    ref = _registry_run("repro", makers)
    got = _registry_run("repro_torch", makers)
    for key in ref:
        assert got[key] == ref[key], key
    # what the trace is meant to exercise
    assert got["cold"] == [2, 3], "two cold starts of 3 steps"
    assert got["quota"] >= 1 and got["rejected"]
    assert ("ready", "scaled_to_zero", 1) in got["states"]
    assert max(s[2] for s in got["states"]) == 3
    assert len(got["outputs"]) == 13 - len(got["rejected"])


def test_default_factory_builds_on_the_requested_device():
    reg = EndpointRegistry([ModelEndpoint(
        name="m", model=get_config(ARCH), device="cpu", capacity=2,
        max_len=64, buckets=(8, 16), kv_backend="paged")])
    eng = reg.resolve("m").engines[0]
    assert eng.device.type == "cpu" and eng.paged
    reqs = [Request(rid=i, model="m", prompt=list(range(1, 9 + i)),
                    sampling=SamplingParams(max_new_tokens=3))
            for i in range(3)]
    for r in reqs:
        assert reg.submit(r, now=0.0)
    reg.run(max_steps=100, now=0.0)
    assert all(r.state is State.DONE and len(r.output) == 3 for r in reqs)


def _serve(*args, cuda=True):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def test_serve_launcher_on_the_cpu(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.txt"
    out = _serve("--arch", "qwen2-0.5b", "--requests", "6", "--device", "cpu",
                 "--trace-out", str(trace), "--metrics-out", str(metrics))
    assert out.returncode == 0, out.stderr
    assert "served 6/6 requests" in out.stdout
    assert "model qwen2-0.5b: state=ready" in out.stdout
    assert trace.stat().st_size > 0
    assert "engine_decode_tokens_total" in metrics.read_text()
    stream = _serve("--arch", "qwen2-0.5b", "--stream", "--device", "cpu")
    assert stream.returncode == 0, stream.stderr
    assert "streamed 4/4 requests to completion" in stream.stdout


def test_serve_launcher_needs_a_gpu_unless_told():
    """Without ``--device cpu`` the launcher asks for the GPU, and with none
    present it raises instead of falling back; ``--dryrun`` traces the
    production decode step on the meta device and needs no GPU."""
    out = _serve("--arch", "qwen2-0.5b", "--requests", "2", cuda=False)
    assert out.returncode != 0 and "served" not in out.stdout
    assert "no CUDA device is available" in out.stderr
    dry = _serve("--arch", "qwen2-0.5b", "--dryrun", cuda=False)
    assert dry.returncode == 0, dry.stderr
    assert "qwen2-0.5b x decode_32k: OK" in dry.stdout and "fits=True" in dry.stdout
