"""The port's stage microservices (``repro_torch.core.microservice``) against
the reference's, on the CPU.

``StagePipeline`` decode steps at 2 and 3 stages, unsplit and with stage 0
scaled to 2 replicas (its rows split 2 + 2), on every decoder-only family:
``qwen2-0.5b-smoke`` at 6 layers (dense), ``mamba2-780m-smoke`` at 4 (SSM),
``jamba-v0.1-52b-smoke`` at 16 (two groups of 8: SSM, attention and MoE
layers) and ``gemma3-27b-smoke`` at 8 (one group of 6 and two tail layers
on the last stage, ring caches that wrap).  Weights are the reference's
seeded init in f32, rescaled to the contracted fan-in with noised norm
scales and biases (``test_torch_training._rescaled_f32``), carried
across by ``from_jax``; KV caches are f32; each package prefills its own
caches from the same prompts.  Logits are held to the reference's within 1e-4
(jamba's 16 layers: 3e-4, see ``CASES``); an unsplit staged step must
equal the port's monolithic ``decode_step`` bit for bit.  The reference's
stage programs donate their cache, so it gets a fresh copy on every call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.core.microservice import StagePipeline as JStagePipeline
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.core import Autoscaler, HPAConfig, StagedLM, StagePipeline
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from test_torch_training import _rescaled_f32

REL = 1e-4
# jamba at 16 layers: the port's monolithic prefill and decode already stand
# up to 1.9e-4 from the reference's here (1e-5 at the 8 layers of
# tests/test_torch_jamba.py): f32 rounding grows with depth through the
# random-init stack.  Staging adds nothing to it: each package's unsplit
# staged step equals its own monolithic step bit for bit (checked below for
# the port; the reference's equals its own too), so the bar holds the same
# drift whether staged or not.
CASES = {"qwen2": ("qwen2-0.5b-smoke", 6, REL), "mamba2": ("mamba2-780m-smoke", 4, REL),
         "jamba": ("jamba-v0.1-52b-smoke", 16, 3e-4), "gemma3": ("gemma3-27b-smoke", 8, REL)}
B, S, MAX_LEN = 4, 40, 64      # gemma3-smoke's ring of 32 wraps


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    """(reference model, its f32 weights, its prefilled caches, port model,
    its weights, its caches, next tokens, positions, the bar) after a
    prefill of the same prompts in each package."""
    arch, layers, bar = CASES[request.param]
    jcfg = dataclasses.replace(jax_get_config(arch), num_layers=layers)
    tcfg = dataclasses.replace(get_config(arch), num_layers=layers)
    raw = JP.init(jax.random.PRNGKey(0), jax_make_model(jcfg).param_specs())
    noise = np.random.default_rng(4)
    np32 = jax.tree_util.tree_map_with_path(lambda p, a: _rescaled_f32(p, a, noise), raw)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    tm = make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32"))
    jp, tp = jax.tree.map(jnp.asarray, np32), P.from_jax(np32, tcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN))(jp, jnp.asarray(toks))
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, MAX_LEN)
    assert _rel(tlog, jlog) < bar
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    return jm, jp, jc, tm, tp, tc, nxt, np.full((B,), S, np.int32), bar


def _clone(caches):
    return P.tree_map(lambda t: t.clone(), caches)


@pytest.mark.parametrize("num_stages", [2, 3])
def test_staged_decode_matches_reference(family, num_stages):
    """Two decode steps unsplit, then two with stage 0 on 2 replicas, each
    against the reference's pipeline in the same state; the unsplit steps
    also bit for bit against the port's monolithic step."""
    jm, jp, jc, tm, tp, tc, nxt, pos, bar = family
    jpipe = JStagePipeline(jm, jp, num_stages)
    tpipe = StagePipeline(tm, tp, num_stages)
    assert tpipe.staged.bounds == jpipe.staged.bounds
    lb = tpipe.staged.layer_bounds
    assert lb[0][0] == 0 and lb[-1][1] == tm.cfg.num_layers
    assert all(a[1] == b[0] for a, b in zip(lb, lb[1:]))
    jcache = jc
    tcache, mono = _clone(tc), _clone(tc)
    for step in range(4):
        split = step >= 2
        if step == 2:
            jpipe.scale_stage(0, 2, now=float(step))
            tpipe.scale_stage(0, 2, now=float(step))
            assert len(tpipe.replicas[0]) == 2
            assert tpipe.replicas[0][1].params[0] is tp["layers"][0]   # shared, not copied
        p = pos + step
        jlog, jcache = jpipe.decode_step(jnp.asarray(nxt), jnp.asarray(p),
                                         jax.tree.map(jnp.copy, jcache), now=float(step))
        tlog, tcache = tpipe.decode_step(_t(nxt).long(), _t(p).long(), tcache,
                                         now=float(step))
        assert tlog.shape == (B, tm.cfg.vocab_size)
        err = _rel(tlog, jlog)
        assert err < bar, (step, err)
        if not split:
            mlog, mono = tm.decode_step(tp, _t(nxt).long(), _t(p).long(), mono)
            assert torch.equal(tlog, mlog), step
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    assert len(tcache) == tm.cfg.num_layers
    for c, spec in zip(tcache, tm.cache_specs(B, MAX_LEN)):
        assert {k: tuple(t.shape) for k, t in c.items()} == {k: s.shape for k, s in spec.items()}
    assert sorted(tpipe.profiler.latency) == [f"stage/{i}" for i in range(len(lb))]
    assert all(tpipe.profiler.alltime_count[f"stage/{i}"] == 4 for i in range(len(lb)))


def test_stage_bounds_match_reference_at_every_count():
    """Group ranges (remainder to the first stages) and layer ranges (tail
    layers on the last stage), at more stages than groups too."""
    for arch, layers, _ in CASES.values():
        jcfg = dataclasses.replace(jax_get_config(arch), num_layers=layers)
        tcfg = dataclasses.replace(get_config(arch), num_layers=layers)
        from repro.core.microservice import StagedLM as JStagedLM
        for n in (1, 2, 3, 4, 5, 17):
            js, ts = JStagedLM(jax_make_model(jcfg), n), StagedLM(make_model(tcfg), n)
            assert ts.bounds == js.bounds and ts.num_stages == js.num_stages
            jm = js.model
            layer_of = [[g * jm.period + j for g in range(g0, g1) for j in range(jm.period)]
                        for g0, g1 in js.bounds]
            layer_of[-1] += jm.tail_layers
            assert [list(range(lo, hi)) for lo, hi in ts.layer_bounds] == layer_of


def test_stage_profiler_drives_hpa():
    """``tests/test_engine.py::test_stage_profiler_drives_hpa`` on the port:
    the profiler ranks stage latencies, the HPA law sizes the bottleneck
    stage, the pipeline scales it, and a split step stays finite."""
    cfg = get_config("qwen2-0.5b-smoke")
    model = make_model(cfg)
    params = P.init(torch.Generator().manual_seed(0), model.param_specs(), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
    logits, cache = model.prefill(params, {"tokens": toks}, 32)
    nxt = logits.argmax(-1)[:, None]
    pos = torch.full((2,), 16)

    pipe = StagePipeline(model, params, num_stages=2)
    for i in range(3):                       # profile a few decode steps
        logits, cache = pipe.decode_step(nxt, pos, cache, now=float(i))
    ranked = pipe.profiler.bottlenecks("stage/")
    assert len(ranked) == 2 and ranked[0][1] >= ranked[1][1]
    hot = int(ranked[0][0].split("/")[1])

    hpa = Autoscaler(HPAConfig(metric="latency", target=ranked[0][1] / 2,
                               tolerance=0.0, max_replicas=4))
    new = hpa.evaluate(3.0, 1, ranked[0][1])
    assert new >= 2
    pipe.scale_stage(hot, new, now=3.0)
    assert len(pipe.replicas[hot]) == new
    logits2, _ = pipe.decode_step(nxt, pos, cache, now=4.0)
    assert torch.isfinite(logits2).all()


def test_encoder_decoder_is_refused():
    cfg = get_config("whisper-small-smoke")
    with pytest.raises(AssertionError, match="decoder-only"):
        JStagePipeline(jax_make_model(jax_get_config("whisper-small-smoke")), None, 2)
    with pytest.raises(ValueError, match="decoder-only"):
        StagePipeline(make_model(cfg), None, 2)
