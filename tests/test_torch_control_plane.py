"""The port's control plane against the JAX package's, on the CPU.

Each scenario runs once per package through the same code, with the
package's own modules: the load balancer, the HPA, the predictors, the
profiler, the proactive scaling policy, the transport and the cache
directory must take the same decisions on the same inputs; an
orchestrator over paged replicas (directory routing, block-granular
migration over a lossy transport, scale-up and scale-down) and a
disaggregated prefill/decode server must give identical outputs,
migration events, directory stats and replica counts.  The replicas get
the reference's f32 weights through ``from_jax``.
"""
import dataclasses
import importlib

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
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "qwen2-0.5b-smoke"
PKGS = ("repro", "repro_torch")
KW = dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8, seed=0)


def core(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    return list(np.maximum(0.0, 5 + 0.2 * t + 3 * np.sin(t / 4)
                           + rng.normal(0, 1, n)))


# ------------------------------------------------------- decision parity
class _Replica:
    def __init__(self, lb_id):
        self.lb_id = lb_id


def _lb(pkg, policy):
    lbm, cd = core(pkg, "loadbalancer"), core(pkg, "cache_directory")
    walk = importlib.import_module(f"{pkg}.serving.prefix_cache").chain_walk
    rng = np.random.default_rng(1)
    directory = cd.ClusterCacheDirectory()
    prompts = [[int(x) for x in rng.integers(0, 50, 40)] for _ in range(6)]
    for i, p in enumerate(prompts):
        for c in walk(p, 8)[: 1 + i % 4]:
            directory.on_insert(i % 4, c)
    lb = lbm.LoadBalancer(policy, seed=3, directory=directory)
    reps = [_Replica(i) for i in range(4)]
    picks = []
    for _ in range(40):
        loads = {r.lb_id: int(x) for r, x in zip(reps, rng.integers(0, 6, 4))}
        p = prompts[int(rng.integers(0, 6))]
        r = lb.pick(reps, load=lambda r: loads[r.lb_id],
                    weight=lambda r: 1.0 + r.lb_id, affinity_key=tuple(p[:8]),
                    tokens=p, block_size=8)
        picks.append(r.lb_id)
    return picks, dataclasses.asdict(directory.stats)


def _hpa(pkg, metric):
    a, pred = core(pkg, "autoscaler"), core(pkg, "predictor")
    cfg = a.HPAConfig(metric=metric, target=4.0, max_replicas=6,
                      stabilization_s=6.0, scale_down_cooldown_s=4.0,
                      proactive=metric == "latency", horizon_s=3.0)
    sc = a.Autoscaler(cfg, pred.make_predictor("holt"))
    cur, out = 1, []
    for t, v in enumerate(_series(60) + _series(30, 1)[::-1]):
        cur = sc.evaluate(float(t), cur, v * cur / 3)
        out.append(cur)
    return out, sc.decisions


def _predictor(pkg, kind):
    pm = core(pkg, "predictor")
    p = pm.make_predictor(kind)
    out = []
    for t, v in enumerate(_series(80, 2)):
        p.observe(float(t), v)
        out.append([p.forecast(h) for h in (0.0, 1.0, 7.5)])
    return out


def _profiler(pkg, _):
    pm = core(pkg, "profiler")
    prof = pm.Profiler(window_s=10.0)
    rng = np.random.default_rng(4)
    for t in range(40):
        for i in range(3):
            prof.observe_latency(f"svc/{i}/decode", float(t),
                                 float(rng.lognormal(-3 + i * 0.3, 0.5)))
            prof.observe_util(f"svc/{i}/kv", float(t), float(rng.random()))
            prof.observe_tokens(f"svc/{i}/prefill", float(t),
                                float(rng.integers(0, 64)))
    return (prof.p("svc/2/decode", 99, 39.0), prof.mean_util("svc/0/kv", 39.0),
            prof.token_rate("svc/1/prefill", 39.0), prof.bottlenecks("svc/", 39.0),
            prof.right_skewed("svc/1/decode", 39.0), prof.hotspot_ratio("svc/"))


def _scaling(pkg, predictor):
    sp = core(pkg, "scaling_policy")
    pol = sp.ProactiveScalingPolicy(sp.ProactiveConfig(predictor=predictor),
                                    cold_start_steps=3, control_every_steps=2)
    cur, out = 1, []
    for k, v in enumerate(_series(40, 3)):
        pol.note_arrival(2.0 * k, 40 * v)
        sig = sp.ScalingSignals(queue_depth=int(v) % 5,
                                queue_tokens=int(30 * v),
                                served_tokens=int(25 * v * cur), steps=2,
                                warm_replicas=cur, total_replicas=cur)
        pol.on_control_tick(2.0 * k, sig)
        cur = max(1, min(8, pol.desired_replicas(2.0 * k, cur, sig)))
        out.append((cur, pol.forecast, pol.capacity, pol.forecast_error))
    return out


def _transport(pkg, faults):
    tm = core(pkg, "transport")
    tp = tm.Transport(tm.LinkSpec(latency_steps=2, bandwidth=300,
                                  max_in_flight=6),
                      tm.FaultSpec(drop=0.2, duplicate=0.15, reorder=0.3,
                                   seed=5) if faults else None)
    got = []
    for node in ("a", "b", "c"):
        tp.register(node, "m", lambda msg, now: got.append(
            (msg.src, msg.dst, msg.payload, now)))
    rng = np.random.default_rng(6)
    accepted = []
    for step in range(30):
        for _ in range(int(rng.integers(0, 4))):
            s, d = rng.choice(["a", "b", "c"], 2, replace=False)
            accepted.append(tp.send(str(s), str(d), "m", step,
                                    size_bytes=int(rng.integers(50, 400)),
                                    reliable=bool(rng.random() < 0.3)))
        if step == 10:
            tp.partition("a", "b")
        if step == 20:
            tp.heal("a", "b")
        tp.step()
    tp.quiesce()
    return accepted, got, tp.counts, tp.bytes_delivered


def _directory(pkg, _):
    cd = core(pkg, "cache_directory")
    walk = importlib.import_module(f"{pkg}.serving.prefix_cache").chain_walk
    rng = np.random.default_rng(7)
    d = cd.ClusterCacheDirectory(max_intents_per_replica=4)
    seqs = [[int(x) for x in rng.integers(0, 20, 48)] for _ in range(5)]
    out = []
    for k, s in enumerate(seqs):
        chains = walk(s, 8)
        for c in chains[: 2 + k % 3]:
            d.on_insert(k % 3, c)
        d.announce((k + 1) % 3, s, 8)
        if k % 2:
            d.on_evict(k % 3, chains[0])
        out.append(sorted(d.overlaps(s, 8).items()))
    out.append(d.reconcile(1, set(walk(seqs[0], 8))))
    out.append(d.drop_replica(2))
    out.append((d.total_entries, d.distinct_chains, sorted(d.replicas())))
    return out, dataclasses.asdict(d.stats)


CASES = {
    **{f"lb-{p}": (_lb, p) for p in ("rr", "least", "p2c", "wjsq", "prefix",
                                     "directory")},
    **{f"hpa-{m}": (_hpa, m) for m in ("queue", "latency")},
    **{f"predictor-{k}": (_predictor, k) for k in ("ewma", "holt", "ar")},
    "profiler": (_profiler, None),
    **{f"scaling-{k}": (_scaling, k) for k in ("holt", "ewma")},
    "transport-lossless": (_transport, False),
    "transport-faults": (_transport, True),
    "directory": (_directory, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decisions_match_reference(case):
    fn, arg = CASES[case]
    ref, got = (fn(pkg, arg) for pkg in PKGS)
    assert got == ref


# ------------------------------------------------------ engines over both

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
    """Per package: a factory of paged replicas sharing one f32 weight
    tree, and the package's Request/SamplingParams."""
    jcfg = jax_get_config(ARCH)
    raw = JP.init(jax.random.PRNGKey(0), jax_make_model(jcfg).param_specs())
    np32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), raw)
    jp = jax.tree.map(jnp.asarray, np32)
    tp = from_jax(np32, get_config(ARCH))
    return {
        "repro": (lambda: _settled(JEngine(jcfg, params=jp, kv_backend="paged",
                                           **KW)),
                  JRequest, JSamplingParams),
        "repro_torch": (lambda: InferenceEngine(
            get_config(ARCH), params=tp, kv_backend="paged", device="cpu",
            **KW), Request, SamplingParams),
    }


def _arrivals():
    """A burst of 14 requests over three steps (a third share a 24-token
    prefix), a quiet tail, then four more with the prefix."""
    rng = np.random.default_rng(0)

    def toks(n):
        return [int(x) for x in rng.integers(0, 500, n)]

    prefix = toks(24)
    out: dict[float, list] = {}
    for i in range(14):
        p = prefix + toks(4 + i % 5) if i % 3 == 0 else toks(6 + (i * 7) % 30)
        out.setdefault(float(i // 5), []).append((i, p, 6 + i % 4))
    for i in range(4):
        out.setdefault(40.0 + i, []).append((100 + i, prefix + toks(3 + i), 5))
    return out


def _orchestrate(pkg, makers):
    make, Req, SP = makers[pkg]
    O, A = core(pkg, "orchestrator"), core(pkg, "autoscaler")
    M, T = core(pkg, "migration"), core(pkg, "transport")
    tp = T.Transport(T.LinkSpec(latency_steps=1, bandwidth=4096,
                                max_in_flight=8),
                     T.FaultSpec(drop=0.2, duplicate=0.1, reorder=0.2, seed=3))
    orch = O.Orchestrator(make, O.OrchestratorConfig(
        max_replicas=3, lb_policy="directory", control_every_steps=2,
        hpa=A.HPAConfig(metric="queue", target=2.0, max_replicas=3,
                        tolerance=0.0, stabilization_s=4.0,
                        scale_down_cooldown_s=4.0),
        migration=M.MigrationConfig(imbalance_threshold=0.3), transport=tp))
    arrivals = _arrivals()
    t, replicas, events = 0.0, [], []
    while t < 300:
        for rid, p, n in arrivals.get(t, []):
            orch.submit(Req(rid=rid, prompt=p,
                            sampling=SP(max_new_tokens=n)), now=t)
        if not orch.pending() and t > max(arrivals):
            break
        orch.step(t)
        replicas.append(len(orch.engines))
        events += [(type(e).__name__, dataclasses.asdict(e))
                   for e in orch.drain_events()]
        t += 1.0
    done = orch.run(max_steps=0)
    return dict(
        outputs={r.rid: list(r.output) for r in done},
        migrations=[(e.rid, e.src, e.dst, e.bytes, e.bytes_full,
                     e.blocks_skipped, e.phase, e.chunks, e.duration_s)
                    for e in orch.migrations.events],
        failures=[dataclasses.asdict(f) for f in orch.migrations.failures],
        directory=dataclasses.asdict(orch.directory.stats),
        scale=orch.scale_history, replicas=replicas, events=events,
        transport=dict(tp.counts),
        hits=sum(r.prefix_hit_tokens for r in done))


def test_orchestrator_matches_reference(makers):
    ref = _orchestrate("repro", makers)
    got = _orchestrate("repro_torch", makers)
    for key in ref:
        assert got[key] == ref[key], key
    # the trace exercises what it is meant to
    assert len(got["outputs"]) == 18
    assert max(got["replicas"]) == 3 and got["replicas"][-1] == 1
    assert got["migrations"] and all(m[7] >= 1 for m in got["migrations"])
    assert got["directory"]["lookup_hit_tokens"] > 0 and got["hits"] > 0
    assert got["transport"]["dropped"] > 0


def _disaggregate(pkg, makers, transport):
    make, Req, SP = makers[pkg]
    D, T = core(pkg, "disaggregation"), core(pkg, "transport")
    tp = T.Transport(T.LinkSpec(latency_steps=1, bandwidth=2048,
                                max_in_flight=8)) if transport else None
    srv = D.DisaggregatedServer(make, D.DisaggConfig(
        prefill_engines=1, decode_engines=2, lb_policy="directory",
        transport=tp))
    shared = list(range(1, 17))
    for i in range(5):
        prompt = shared + [30 + i] * (2 + 9 * (i % 2))   # one is chunked
        srv.submit(Req(rid=i, prompt=prompt, sampling=SP(max_new_tokens=6)),
                   now=0.0)
    t = 0.0
    while srv.pending() and t < 400:
        srv.step(t)
        t += 1.0
    done = srv.run(max_steps=0)
    return ({r.rid: list(r.output) for r in done},
            [(e.rid, e.src, e.dst, e.bytes, e.blocks_skipped, e.phase,
              e.chunks) for e in srv.migrations.events])


@pytest.mark.parametrize("transport", [False, True])
def test_disaggregated_handoff_matches_reference(makers, transport):
    ref = _disaggregate("repro", makers, transport)
    got = _disaggregate("repro_torch", makers, transport)
    assert got == ref
    assert len(got[0]) == 5 and len(got[1]) == 5
    assert {m[5] for m in got[1]} == {"decode", "prefill"}
