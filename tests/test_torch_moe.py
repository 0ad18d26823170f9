"""The PyTorch port's MoE family (qwen3-moe) against the JAX reference, on
the CPU.

Two configs, built the same way in both packages: ``qwen3-moe-30b-a3b-smoke``
(4 experts, top-4: nothing can drop) and a dropping variant (16 experts,
top-4, capacity factor 0.5, so a row gives each expert fewer slots than
its tokens ask for).  Weights are the reference's seeded init carried
across by ``from_jax`` in f32, with nonzero norm scales; inputs come from
numpy.  Top-K over near-equal router probabilities may order differently
in the two libraries, so every test that compares routing first asserts a
minimum gap between the sorted probabilities of its inputs.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "qwen3-moe-30b-a3b-smoke"
DROPPING = dict(num_experts=16, experts_per_token=4, capacity_factor=0.5)
CONFIGS = ["smoke", "dropping"]
REL = 1e-4
MIN_GAP = 1e-5          # between consecutive sorted router probabilities
REPO = Path(__file__).resolve().parents[1]


def _cfgs(name):
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if name == "dropping":
        jcfg = dataclasses.replace(jcfg, **DROPPING)
        tcfg = dataclasses.replace(tcfg, **DROPPING)
    return jcfg, tcfg


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", params=CONFIGS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    raw = jax.tree.map(np.asarray, JP.init(jax.random.PRNGKey(0), jm.param_specs()))
    noise = np.random.default_rng(4)

    def f32(path, a):
        a = a.astype(np.float32)
        if path[-1].key == "scale":     # nonzero norm scales, q/k norms too
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    return jcfg, tcfg, jm, raw, jax.tree.map(jnp.asarray, np32), P.from_jax(np32, tcfg)


def _layer(jp, tp, i=0):
    return jax.tree.map(lambda a: a[i], jp["blocks"]["m0"]), tp["layers"][i]


def _assert_topk_margin(probs, K):
    """The inputs route without near-ties: consecutive sorted probabilities,
    down to the first one past the top-K, differ by at least MIN_GAP."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=-1)[..., : K + 1]
    assert np.diff(-s, axis=-1).min() >= MIN_GAP


# ------------------------------------------------------------ parameters
def test_from_jax_carries_every_moe_leaf(setup):
    """router, w_gate/w_up/w_down and q_norm/k_norm arrive bit-identical,
    unstacked per layer, and the tree has exactly the port's spec leaves."""
    _, tcfg, _, raw, _, _ = setup
    params = P.from_jax(raw, tcfg)
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(raw):
        keys = [p.key for p in path]
        for i in range(tcfg.num_layers) if keys[0] == "blocks" else [None]:
            t = params["layers"][i] if i is not None else params
            for k in keys[2:] if i is not None else keys:
                t = t[k]
            want = np.asarray(leaf[i] if i is not None else leaf)
            assert tuple(t.shape) == want.shape, keys
            assert t.dtype == P.to_tensor(want).dtype, keys
            np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
            n += 1
    specs = make_model(tcfg).param_specs()
    assert n == len(P.tree_leaves(specs))
    layer = params["layers"][0]
    assert set(layer["mlp"]) == {"router", "w_gate", "w_up", "w_down"}
    assert {"q_norm", "k_norm"} <= set(layer["mixer"])
    assert tuple(layer["mlp"]["w_down"].shape) == (tcfg.num_experts, tcfg.moe_d_ff,
                                                   tcfg.d_model)


def test_init_draws_every_expert_leaf_at_its_fan_in():
    """The port's own init: a 3-D expert leaf is drawn at 1/sqrt of its
    contracted (second-to-last) dim; norm scales start at zero."""
    cfg = dataclasses.replace(get_config(ARCH), num_experts=8, moe_d_ff=256)
    specs = make_model(cfg).param_specs()
    params = P.init(torch.Generator().manual_seed(0), specs, "cpu")
    mlp, mixer = params["layers"][0]["mlp"], params["layers"][0]["mixer"]
    for name, fan_in in (("router", cfg.d_model), ("w_gate", cfg.d_model),
                         ("w_up", cfg.d_model), ("w_down", cfg.moe_d_ff)):
        std = float(mlp[name].float().std())
        assert abs(std * math.sqrt(fan_in) - 1.0) < 0.05, (name, std)
    assert not mixer["q_norm"]["scale"].any() and not mixer["k_norm"]["scale"].any()


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("seed", range(6))
def test_rank_within_expert_matches_reference(seed):
    """Identical integer ranks on expert ids with many ties."""
    rng = np.random.default_rng(seed)
    B, T = int(rng.integers(1, 5)), int(rng.integers(1, 200))
    e = rng.integers(0, int(rng.integers(1, 9)), (B, T)).astype(np.int32)
    got = L._rank_within_expert(_t(e).long())
    want = np.asarray(JL._rank_within_expert(jnp.asarray(e)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_qk_norm_projection_matches_reference(setup):
    jcfg, tcfg, _, _, jp, tp = setup
    jl, tl = _layer(jp, tp)
    assert jcfg.qk_norm and float(np.abs(np.asarray(jl["mixer"]["q_norm"]["scale"])).max()) > 0
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]], np.int32)
    got = L._project_qkv(tl["mixer"], _t(x), tcfg, _t(pos), tcfg.rope_theta)
    want = JL._project_qkv(jl["mixer"], x, jcfg, pos, jcfg.rope_theta)
    for a, b in zip(got, want):
        assert _rel(a, b) < REL


def test_moe_apply_matches_reference(setup):
    """Same slots (dropped assignments included), y within 1e-5, aux within
    1e-6.  The dropping config really drops."""
    jcfg, tcfg, _, _, jp, tp = setup
    jl, tl = _layer(jp, tp)
    E, K = tcfg.num_experts, tcfg.experts_per_token
    B, S = 3, 24
    x = np.random.default_rng(2).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    router = np.asarray(jl["mlp"]["router"])
    jprobs = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    _assert_topk_margin(jprobs, K)

    # the reference's dispatch plan, from its own top-K and ranks
    _, jidx = jax.lax.top_k(jprobs, K)
    C = max(1, int(math.ceil(S * K / E * jcfg.capacity_factor)))
    je = jidx.reshape(B, S * K)
    jranks = JL._rank_within_expert(je)
    jslot = np.asarray(jnp.where(jranks < C, je * C + jranks, E * C))
    _, tidx = torch.topk(torch.softmax(_t(x) @ tl["mlp"]["router"], -1), K, dim=-1)
    tslot, tC = L.moe_slots(tidx, tcfg)
    assert tC == C
    np.testing.assert_array_equal(tslot.numpy(), jslot)
    dropped = int((jslot == E * C).sum())
    if tcfg.num_experts == K:
        assert dropped == 0
    else:
        assert dropped > 0, "the dropping config should drop assignments"

    y, aux = L.moe_apply(tl["mlp"], _t(x), tcfg)
    jy, jaux = JL.moe_apply(jl["mlp"], jnp.asarray(x), jcfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y, jy) < 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 1000))
def test_moe_weight_conservation(seed):
    """Without capacity drops, per-token routed weights sum to 1 and the
    layer output is the convex combination of its top-K experts' outputs
    (computed here token by token); in bf16 the output is finite."""
    cfg = dataclasses.replace(get_config(ARCH), num_experts=8, experts_per_token=2,
                              capacity_factor=100.0)
    gen = torch.Generator().manual_seed(seed)
    p = P.tree_map(lambda t: t.float(), P.init(gen, L.moe_specs(cfg), "cpu"))
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    y, aux = L.moe_apply(p, x, cfg)
    assert y.shape == x.shape and math.isfinite(float(aux))
    probs = torch.softmax(x @ p["router"], -1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    torch.testing.assert_close(w.sum(-1), torch.ones(2, 8))
    want = torch.zeros_like(x)
    for b in range(2):
        for s in range(8):
            for k in range(cfg.experts_per_token):
                e = int(idx[b, s, k])
                h = torch.nn.functional.silu(x[b, s] @ p["w_gate"][e]) * (x[b, s] @ p["w_up"][e])
                want[b, s] += w[b, s, k] * (h @ p["w_down"][e])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    pb = P.tree_map(lambda t: t.bfloat16(), p)
    yb, _ = L.moe_apply(pb, x.bfloat16(), cfg)
    assert yb.dtype == torch.bfloat16 and bool(torch.isfinite(yb.float()).all())


# ------------------------------------------------------------ LM modes
def test_lm_modes_match_reference(setup):
    """Each mode against the same mode of the reference (MoE capacity is per
    call): prefill -> decode; two chunks on a pool cache; two paged chunks
    -> paged decode with a dead row.  Logits within 1e-4, f32 KV."""
    jcfg, tcfg, jm, _, jp, tp = setup
    tm = make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32"))
    rng = np.random.default_rng(2)
    B, S, max_len, V = 3, 16, 48, tcfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    true = np.array([16, 11, 5], np.int32)

    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len,
                          true_len=jnp.asarray(true))
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, max_len, true_len=_t(true))
    assert _rel(tlog, jlog) < REL
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    jlog, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(true), jc)
    tlog, _ = tm.decode_step(tp, _t(nxt).long(), _t(true).long(), tc)
    assert _rel(tlog, jlog) < REL

    C = 8
    chunks = [(np.array([0, 0, 0]), np.array([8, 8, 0])),
              (np.array([8, 8, 0]), np.array([8, 3, 5]))]

    def part(pos0):
        return np.stack([toks[b, pos0[b]:pos0[b] + C] if pos0[b] + C <= S
                         else np.zeros(C, np.int32) for b in range(B)])

    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, max_len)))
    tcache = P.tree_map(lambda t: t.float(), P.init(None, tm.cache_specs(B, max_len), "cpu"))
    for pos0, nval in chunks:
        jlog, jcache = jm.prefill_chunk(jp, jnp.asarray(part(pos0)), jnp.asarray(pos0, jnp.int32),
                                        jnp.asarray(nval, jnp.int32), jcache)
        tlog, tcache = tm.prefill_chunk(tp, _t(part(pos0)).long(), _t(pos0), _t(nval), tcache)
        assert _rel(tlog[nval > 0], np.asarray(jlog)[nval > 0]) < REL

    nb, bs, max_blk = 16, 4, 6
    table = np.full((B, max_blk), -1, np.int32)
    perm = np.random.default_rng(3).permutation(nb)
    table[0, :5], table[1, :4], table[2, :2] = perm[:5], perm[5:9], perm[9:11]
    jpools = JP.init(jax.random.PRNGKey(0), jm.paged_cache_specs(nb, bs))
    tpools = P.init(None, tm.paged_cache_specs(nb, bs), "cpu")
    for pos0, nval in chunks:
        jlog, jpools = jm.prefill_chunk_paged(
            jp, jnp.asarray(part(pos0)), jnp.asarray(pos0, jnp.int32),
            jnp.asarray(nval, jnp.int32), jpools, jnp.asarray(table))
        tlog, tpools = tm.prefill_chunk_paged(tp, _t(part(pos0)).long(), _t(pos0),
                                              _t(nval), tpools, _t(table))
        assert _rel(tlog[nval > 0], np.asarray(jlog)[nval > 0]) < REL
    pos, live = np.array([16, 11, 5], np.int32), np.array([True, True, False])
    nxt = np.asarray(tlog).argmax(-1)[:, None].astype(np.int32)
    jlog, _ = jm.decode_step_paged(jp, jnp.asarray(nxt), jnp.asarray(pos), jpools,
                                   jnp.asarray(table), jnp.asarray(live))
    tlog, _ = tm.decode_step_paged(tp, _t(nxt).long(), _t(pos).long(), tpools,
                                   _t(table), _t(live))
    assert _rel(tlog, jlog) < REL


# ---------------------------------------------------------------- engine
ENGINE_KW = dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8)


def _serve(eng, make_req, make_sp, settle=None):
    """Five requests at step 0 (one of 40 tokens goes chunked), greedy, on
    a logical clock; returns {rid: tokens}."""
    rng = np.random.default_rng(3)
    for i, n in enumerate((5, 11, 40, 7, 14)):
        eng.submit(make_req(rid=i, prompt=[int(x) for x in rng.integers(0, 512, n)],
                            sampling=make_sp(max_new_tokens=5)), now=0.0)
    t = 0.0
    while eng.pending() and t < 200:
        eng.step(now=t)
        if settle is not None:
            settle(eng)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_engine_greedy_matches_reference(backend):
    """The reference engine waits for its device work after every step (see
    tests/test_torch_control_plane.py::_settled)."""
    jcfg, tcfg = _cfgs("smoke")
    specs = jax_make_model(jcfg).param_specs()
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           JP.init(jax.random.PRNGKey(0), specs))
    tparams = P.from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    ref = _serve(JEngine(jcfg, params=jparams, kv_backend=backend, **ENGINE_KW),
                 JRequest, JSamplingParams,
                 settle=lambda e: jax.block_until_ready(e.caches))
    teng = InferenceEngine(tcfg, params=tparams, kv_backend=backend, device="cpu",
                           **ENGINE_KW)
    got = _serve(teng, Request, SamplingParams)
    assert len(got) == 5 and all(len(v) == 5 for v in got.values())
    assert got == ref
    assert any(st.chunk_rows for st in teng.history), "no prompt went chunked"


def test_serve_launcher_serves_qwen3_moe_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--requests", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert "model qwen3-moe-30b-a3b: state=ready" in out.stdout
