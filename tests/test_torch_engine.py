"""The PyTorch port's serving engine against the JAX engine, on the CPU.

Both engines get the same f32 weights (the reference's seeded init, passed
through ``from_jax``) and the same trace on a logical clock.  Greedy
outputs must be token-identical, the per-step counters and the event
streams equal, on the dense and on the paged KV backend.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import CompletionRequest as JCompletionRequest
from repro.serving import CompletionsAPI as JCompletionsAPI
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import sampling as jax_sampling
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.serving import (CompletionRequest, CompletionsAPI,
                                 InferenceEngine, Request, SamplingParams, State)
from repro_torch.serving.sampling import filter_logits, sample

ARCH = "qwen2-0.5b-smoke"
ENGINE_KW = dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    """f32 reference params and the port's copy of them."""
    jcfg = jax_get_config(ARCH)
    specs = jax_make_model(jcfg).param_specs()
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           JP.init(jax.random.PRNGKey(0), specs))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), get_config(ARCH))
    return jparams, tparams


def _prompts():
    rng = np.random.default_rng(3)
    vocab = get_config(ARCH).vocab_size

    def toks(n):
        return [int(x) for x in rng.integers(0, vocab, n)]

    shared = toks(19)
    # wave 1: bucketed (<=16), chunked (>16) and shared-prefix prompts;
    # wave 2 (submitted later) re-uses the prefix after wave 1 retired
    wave1 = [toks(5), toks(11), toks(40), shared + toks(4), toks(7), toks(33)]
    wave2 = [shared + toks(9), shared + toks(2), toks(14)]
    return wave1, wave2


def _serve(eng, make_req, make_sp, wave1, wave2):
    """Drive an engine on a logical clock: wave 1 at step 0, wave 2 once the
    engine is idle.  Returns (outputs, per-step counters, events)."""
    for i, p in enumerate(wave1):
        eng.submit(make_req(rid=i, prompt=list(p), sampling=make_sp(max_new_tokens=6)),
                   now=0.0)
    stats, events, t = [], [], 0.0
    submitted2 = False
    while t < 400:
        if not eng.pending():
            if submitted2:
                break
            for i, p in enumerate(wave2):
                eng.submit(make_req(rid=100 + i, prompt=list(p),
                                    sampling=make_sp(max_new_tokens=6)), now=t)
            submitted2 = True
        st = eng.step(now=t)
        stats.append((st.prefill_tokens, st.chunk_rows, st.prefix_hit_tokens,
                      st.kv_blocks_used, st.tokens_out, st.n_prefill,
                      st.occupancy, st.prefill_tokens_padded))
        events.extend((type(e).__name__, dataclasses.asdict(e)) for e in st.events)
        t += 1.0
    outs = {r.rid: list(r.output) for r in eng.finished}
    return outs, stats, events


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_matches_reference(weights, backend):
    jparams, tparams = weights
    wave1, wave2 = _prompts()
    jeng = JEngine(jax_get_config(ARCH), params=jparams, kv_backend=backend,
                   **ENGINE_KW)
    teng = InferenceEngine(get_config(ARCH), params=tparams, kv_backend=backend,
                           device="cpu", **ENGINE_KW)
    ref = _serve(jeng, JRequest, JSamplingParams, wave1, wave2)
    got = _serve(teng, Request, SamplingParams, wave1, wave2)
    assert len(got[0]) == len(wave1) + len(wave2)
    assert got[0] == ref[0], "greedy outputs differ"
    assert got[1] == ref[1], "StepStats counters differ"
    assert got[2] == ref[2], "event streams differ"
    if backend == "paged":
        assert sum(s[2] for s in got[1]) > 0, "trace should hit the prefix cache"
        teng.prefix.check_invariants()


def test_shared_tail_cow_matches_reference(weights):
    """A continuation prompt matches a partially filled cached tail block:
    the port copies it on write and continues exactly as the reference."""
    jparams, tparams = weights
    p0 = [int(x) for x in np.random.default_rng(5).integers(0, 512, 12)]
    outs = []
    for Eng, Req, SP, kw in ((JEngine, JRequest, JSamplingParams, {"params": jparams}),
                             (InferenceEngine, Request, SamplingParams,
                              {"params": tparams, "device": "cpu"})):
        cfg = (jax_get_config if Eng is JEngine else get_config)(ARCH)
        eng = Eng(cfg, kv_backend="paged", **ENGINE_KW, **kw)
        eng.submit(Req(rid=0, prompt=list(p0), sampling=SP(max_new_tokens=3)))
        turn1 = eng.run(max_steps=100)[0]
        cont = list(p0) + turn1.output[:2] + [7]
        eng.finished.clear()
        eng.submit(Req(rid=1, prompt=cont, sampling=SP(max_new_tokens=4)))
        got = eng.run(max_steps=100)[0]
        assert got.prefix_hit_tokens % eng.block_size != 0, "tail block matched"
        assert eng.prefix.cow_copies >= 1
        outs.append((turn1.output, got.output, got.prefix_hit_tokens))
    assert outs[0] == outs[1]


def _slo_guard_run(eng, make_req, make_sp):
    """A decode row whose TPOT breaches its SLO preempts a mid-prefill row
    (the timeline of tests/test_streaming.py), then both finish."""
    rng = np.random.default_rng(6)
    a = make_req(rid=0, prompt=[int(x) for x in rng.integers(0, 512, 5)],
                 sampling=make_sp(max_new_tokens=8), slo_tpot=2.0)
    b = make_req(rid=1, prompt=[int(x) for x in rng.integers(0, 512, 40)],
                 sampling=make_sp(max_new_tokens=4))
    eng.submit(a, now=0.0)
    events = []
    for t in (0.0, 1.0, 2.0, 9.0, 10.0) + tuple(float(x) for x in range(11, 60)):
        if t == 2.0:
            eng.submit(b, now=2.0)
        st = eng.step(now=t)
        events.extend((type(e).__name__, dataclasses.asdict(e)) for e in st.events)
        if not eng.pending():
            break
    return a.output, b.output, b.preemptions, events


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_slo_guard_matches_reference(weights, backend):
    from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
    from repro_torch.serving.scheduler import SchedulerConfig
    jparams, tparams = weights
    kw = dict(ENGINE_KW, kv_backend=backend)
    jeng = JEngine(jax_get_config(ARCH), params=jparams, **kw,
                   sched=JSchedulerConfig(slo_guard=True, slo_guard_patience=1))
    teng = InferenceEngine(get_config(ARCH), params=tparams, device="cpu", **kw,
                           sched=SchedulerConfig(slo_guard=True, slo_guard_patience=1))
    ref = _slo_guard_run(jeng, JRequest, JSamplingParams)
    got = _slo_guard_run(teng, Request, SamplingParams)
    assert got[2] == 1, "the mid-prefill row should be preempted once"
    assert got == ref


def test_too_long_prompt_rejected(weights):
    _, tparams = weights
    eng = InferenceEngine(get_config(ARCH), params=tparams, device="cpu",
                          **ENGINE_KW)
    req = Request(rid=0, prompt=[1] * ENGINE_KW["max_len"])
    assert eng.submit(req, now=0.0) is False
    assert req.state is State.REJECTED and eng.rejected_long == 1
    assert eng.pending() == 0


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.7, 40, 1.0), (1.0, 0, 0.9), (0.5, 5, 0.5), (1.3, 3, 0.99)])
def test_sampling_masks_match_reference(monkeypatch, temp, top_k, top_p):
    """The top-k / top-p cuts are the reference's: the logits the reference
    hands to ``jax.random.categorical`` equal the port's filtered logits."""
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(3, 64)) * 3).astype(np.float32)
    logits[1, :8] = logits[1, 0]                      # ties at the top
    temp_a = np.array([temp, temp, 0.0], np.float32)
    topk_a = np.array([top_k, top_k, top_k], np.int32)
    topp_a = np.array([top_p, top_p, top_p], np.float32)
    seen = []

    def capture(key, scaled, axis=-1):
        seen.append(np.asarray(scaled))
        return jnp.zeros(scaled.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_sampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                        jnp.asarray(temp_a), jnp.asarray(topk_a), jnp.asarray(topp_a))
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(temp_a),
                        torch.from_numpy(topk_a.astype(np.int64)),
                        torch.from_numpy(topp_a)).numpy()
    ref = seen[0]
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    keep = ref > -1e29
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)


def test_sampling_greedy_and_distribution():
    """Greedy rows are argmax; sampled rows follow softmax of the filtered
    logits (draws from a seeded torch.Generator)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5], [2.0, 0.0, 0.0, 0.0]]).repeat(4000, 1)
    B = logits.shape[0]
    temp = torch.tensor([1.0, 0.0]).repeat(4000)
    gen = torch.Generator().manual_seed(0)
    out = sample(logits, gen, temp, torch.zeros(B, dtype=torch.long),
                 torch.ones(B))
    assert (out[1::2] == 0).all()
    freq = torch.bincount(out[0::2], minlength=4).float() / 4000
    expect = torch.softmax(logits[0], -1)
    assert torch.allclose(freq, expect, atol=0.03), (freq, expect)


def test_completions_api_over_port_engine(weights):
    jparams, tparams = weights
    prompt = [int(x) for x in np.random.default_rng(9).integers(0, 512, 21)]
    jeng = JEngine(jax_get_config(ARCH), params=jparams, **ENGINE_KW)
    ref = JCompletionsAPI(jeng, model="m").create(
        JCompletionRequest(prompt=prompt, model="m", max_tokens=5), now=0.0)
    teng = InferenceEngine(get_config(ARCH), params=tparams, device="cpu",
                           **ENGINE_KW)
    api = CompletionsAPI(teng, model="m")
    got = api.create(CompletionRequest(prompt=prompt, model="m", max_tokens=5),
                     now=0.0)
    assert got.choices[0].tokens == ref.choices[0].tokens
    assert got.choices[0].finish_reason == "length"
    chunks = list(api.stream(CompletionRequest(prompt=prompt, model="m",
                                               max_tokens=5), now=50.0))
    streamed = [t for c in chunks for t in c.choices[0]["tokens"]]
    assert streamed == ref.choices[0].tokens
    assert chunks[-1].choices[0]["finish_reason"] == "length"


def test_entry_points_refuse_cpu_fallback():
    """Without a GPU, an engine that is not asked for the CPU raises; a
    tensor that is not on the CPU never reaches a plain kernel version:
    inputs split across devices raise, and ``meta`` inputs (the dry run)
    take the wrapper's meta branch, which reports the kernel's work."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.launch.cost import OpCounter
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(get_config(ARCH))
    q = torch.empty((2, 4, 16), device="meta")
    pool = torch.empty((4, 8, 1, 16), device="meta")
    tbl = torch.empty((2, 3), dtype=torch.int32, device="meta")
    ctx = torch.empty((2,), dtype=torch.int32, device="meta")
    x = torch.empty((1, 8, 4, 16), device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, tbl, torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError):
        attention(x, torch.zeros((1, 8, 1, 16)), x[:, :, :1])
    with OpCounter() as c:
        out = paged_decode_attention(q, pool, pool, tbl, ctx)
        o2 = attention(x, x[:, :, :1], x[:, :, :1])
    assert c.kernels == {"paged_attention": 1, "flash_attention": 1}
    assert out.device.type == o2.device.type == "meta"


_NO_JAX = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import torch
import chip_smoke  # noqa: F401  (module level only; main() is not run)
import repro_torch.core  # noqa: F401  (the simulator and the stage pipeline too)
import repro_torch.examples.elastic_failover  # noqa: F401
import repro_torch.examples.quickstart  # noqa: F401
import repro_torch.examples.serve_autoscaling  # noqa: F401
import repro_torch.examples.train_tiny  # noqa: F401
import repro_torch.training.train_loop  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.serving import InferenceEngine, Request, SamplingParams
for arch, backend in (("qwen2-0.5b-smoke", "dense"), ("qwen2-0.5b-smoke", "paged"),
                      ("mamba2-780m-smoke", "dense")):
    eng = InferenceEngine(get_config(arch), capacity=2, max_len=32,
                          buckets=(8,), block_size=8, kv_backend=backend,
                          device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2, 3], sampling=SamplingParams(max_new_tokens=3)))
    done = eng.run(max_steps=20)
    assert len(done) == 1 and len(done[0].output) == 3, done
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("ok")
"""


def test_port_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    res = subprocess.run([sys.executable, "-c", _NO_JAX], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
