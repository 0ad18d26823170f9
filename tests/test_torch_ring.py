"""The PyTorch port's ring/local attention (gemma3, mixtral) against the JAX
reference, on the CPU.

``gemma3-27b-smoke`` has one whole period of gemma3's layer pattern (five
local layers of window 32, then a global one), q/k RMSNorm, GeGLU, two rope
thetas and a scaled, tied embedding; ``mixtral-8x7b-smoke`` a uniform
window of 64 over MoE layers.  Weights are the reference's seeded init
carried across by ``from_jax`` in f32, with nonzero norm scales; inputs
come from numpy.  Prompts run past the window, so the ring caches wrap.
Cache writes are held bit for bit; logits within 1e-4 with f32 KV; engines
to identical greedy tokens (the reference engine waits at the end of each
step, see tests/test_torch_control_plane.py::_settled).
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
from repro.configs.perf import BASELINE as JBASELINE
from repro.kernels.flash_attention.ops import attention as jax_flash
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

GEMMA = "gemma3-27b-smoke"
MIXTRAL = "mixtral-8x7b-smoke"
REL = 1e-4
REPO = Path(__file__).resolve().parents[1]


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f32_params(jcfg, seed=4):
    """The reference's init in f32 with nonzero norm scales: (numpy tree,
    jnp tree)."""
    raw = JP.init(jax.random.PRNGKey(0), jax_make_model(jcfg).param_specs())
    noise = np.random.default_rng(seed)

    def f32(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "scale":
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    return np32, jax.tree.map(jnp.asarray, np32)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


# ------------------------------------------------------ ring cache functions
KV, HD = 2, 4


def _ring_cache(rng, B, W, fill_to=None):
    """A ring cache of W slots holding positions 0 .. fill_to[b]-1 (the last
    W of them), random k/v, -1 past them; fill_to None: empty."""
    k = rng.normal(size=(B, W, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, W, KV, HD)).astype(np.float32)
    pos = np.full((B, W), -1, np.int32)
    for b, n in enumerate(fill_to if fill_to is not None else [0] * B):
        for p in range(max(0, n - W), n):
            pos[b, p % W] = p
    if fill_to is None:
        k[:], v[:] = 0.0, 0.0
    return {"k": k, "v": v, "pos": pos}


def _to_torch(cache):
    return {n: _t(a.copy()) for n, a in cache.items()}


def _assert_cache_equal(got, want):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)


def _case_prefill(rng, true_len):
    B, S, W = 3, 40, 16
    k = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    empty = _ring_cache(rng, B, W)
    tl = None if true_len is None else np.asarray(true_len, np.int32)
    want = JL.cache_write_prefill(
        jax.tree.map(jnp.asarray, empty), jnp.asarray(k), jnp.asarray(v),
        ring=True, window=W, true_len=None if tl is None else jnp.asarray(tl))
    got = L.cache_write_prefill(_to_torch(empty), _t(k), _t(v), ring=True,
                                true_len=None if tl is None else _t(tl))
    _assert_cache_equal(got, want)


def _case_chunk(rng):
    """A chunk of 24 into rings of 16, rows starting at 0, 5 and 30; two
    idle rows keep their cache bit for bit."""
    B, C, W = 5, 24, 16
    pos0 = np.array([0, 5, 30, 7, 0], np.int32)
    nval = np.array([24, 13, 20, 0, 0], np.int32)
    cache = _ring_cache(rng, B, W, fill_to=list(pos0))
    k = rng.normal(size=(B, C, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, C, KV, HD)).astype(np.float32)
    want = JL.cache_write_chunk(jax.tree.map(jnp.asarray, cache), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos0), jnp.asarray(nval),
                                ring=True)
    got = L.cache_write_chunk(_to_torch(cache), _t(k), _t(v), _t(pos0), _t(nval),
                              ring=True)
    _assert_cache_equal(got, want)
    for b in (3, 4):
        for n in cache:
            np.testing.assert_array_equal(got[n][b].numpy(), cache[n][b])


def _case_attention_chunk(rng):
    """Queries at pos0 .. pos0+C-1 over a ring written to pos0 and this
    chunk's own k/v, the window biting in both."""
    B, C, W, H, window = 3, 24, 16, 4, 16
    pos0 = np.array([0, 9, 40], np.int32)
    cache = _ring_cache(rng, B, W, fill_to=list(pos0))
    q = rng.normal(size=(B, C, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, C, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, C, KV, HD)).astype(np.float32)
    want = JL.attention_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jax.tree.map(jnp.asarray, cache), jnp.asarray(pos0),
                              window=window, ring=True)
    got = L.attention_chunk(_t(q), _t(k), _t(v), _to_torch(cache), _t(pos0),
                            window=window, ring=True, q_chunk=10)
    assert _rel(got, want) < 1e-6


def _case_decode(rng):
    """Decode writes across the wrap (positions 15, 16, 33 into 16 slots); a
    row that is not live keeps every leaf, its positions included."""
    B, W = 4, 16
    pos = np.array([15, 16, 33, 20], np.int32)
    live = np.array([True, True, True, False])
    cache = _ring_cache(rng, B, W, fill_to=list(pos))
    k = rng.normal(size=(B, 1, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, 1, KV, HD)).astype(np.float32)
    jc = JL.cache_write_decode(jax.tree.map(jnp.asarray, cache), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pos), ring=True)
    # the reference engine keeps a row that is not live by a select
    want = {n: np.where(live.reshape(-1, *[1] * (a.ndim - 1)), np.asarray(jc[n]), a)
            for n, a in cache.items()}
    got = L.cache_write_decode(_to_torch(cache), _t(k), _t(v), _t(pos).long(),
                               live=_t(live), ring=True)
    _assert_cache_equal(got, want)
    np.testing.assert_array_equal(got["pos"][3].numpy(), cache["pos"][3])


def _case_valid_mask(rng):
    B, W = 4, 16
    pos = np.array([3, 16, 40, 0], np.int32)
    cache = _ring_cache(rng, B, W, fill_to=[4, 17, 41, 1])
    for window in (16, 9):
        want = JL.cache_valid_mask(jax.tree.map(jnp.asarray, cache), jnp.asarray(pos),
                                   ring=True, window=window)
        got = L.cache_valid_mask(_to_torch(cache), _t(pos).long(), ring=True,
                                 window=window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


RING_CASES = {
    "prefill": lambda rng: _case_prefill(rng, None),
    "prefill_true_len": lambda rng: _case_prefill(rng, [40, 25, 17]),
    "prefill_true_len_below_ring": lambda rng: _case_prefill(rng, [9, 1, 16]),
    "chunk_longer_than_ring": _case_chunk,
    "attention_chunk_window": _case_attention_chunk,
    "decode_across_wrap": _case_decode,
    "valid_mask": _case_valid_mask,
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_function_matches_reference(case):
    RING_CASES[case](np.random.default_rng(sorted(RING_CASES).index(case)))


# ---------------------------------------------------------------- LM modes
@pytest.fixture(scope="module", params=[6, 8], ids=["6_layers", "8_layers"])
def gemma(request):
    """gemma3-27b-smoke at 6 layers (one period), and at 8 (two tail layers,
    t6 and t7 in the reference's tree)."""
    jcfg, tcfg = _cfgs(GEMMA, num_layers=request.param)
    np32, jp = _f32_params(jcfg)
    return jcfg, tcfg, np32, jp, P.from_jax(np32, tcfg)


def test_from_jax_carries_the_tail_layers(gemma):
    jcfg, tcfg, np32, _, tp = gemma
    specs = make_model(tcfg).param_specs()
    assert len(P.tree_leaves(tp)) == len(P.tree_leaves(specs))
    tail = [i for i in range(tcfg.num_layers) if i >= 6]
    assert sorted(np32.get("tail", {})) == [f"t{i}" for i in tail]
    for i in tail:
        for n in ("wq", "wk"):
            np.testing.assert_array_equal(tp["layers"][i]["mixer"][n].numpy(),
                                          np32["tail"][f"t{i}"]["mixer"][n])
    assert make_model(tcfg).kinds == [jcfg.layer_kind(i) for i in range(jcfg.num_layers)]


def test_lm_modes_match_reference(gemma):
    """Prefill, bucketed prefill (true_len), two chunks on a pool cache with
    an idle row, then decode across the wrap; every mode against the same
    mode of the reference, prompts past the window of 32."""
    jcfg, tcfg, _, jp, tp = gemma
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    tm = make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32", q_chunk=16))
    rng = np.random.default_rng(2)
    B, S, max_len, V = 3, 48, 96, tcfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)

    jlog, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    tlog, _ = tm.prefill(tp, {"tokens": _t(toks).long()}, max_len)
    assert _rel(tlog, jlog) < REL

    true = np.array([48, 37, 9], np.int32)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len,
                          true_len=jnp.asarray(true))
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, max_len, true_len=_t(true))
    assert _rel(tlog, jlog) < REL
    for j in range(6):           # layer j of the first group
        for n in ("k", "v", "pos"):
            if n in jc["blocks"][f"m{j}"]:
                ref = np.asarray(jc["blocks"][f"m{j}"][n][0])
                if n == "pos":
                    np.testing.assert_array_equal(tc[j][n].numpy(), ref)
                else:
                    assert _rel(tc[j][n], ref) < REL
    pos, nxt = true.copy(), np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tlog, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc)
        assert _rel(tlog, jlog) < REL
        nxt, pos = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None], pos + 1

    C = 40                       # longer than the ring of 32
    chunks = [(np.array([0, 0, 0]), np.array([40, 20, 0])),
              (np.array([40, 20, 0]), np.array([8, 28, 35]))]
    long = rng.integers(0, V, (B, 96)).astype(np.int32)

    def part(pos0):
        return np.stack([long[b, pos0[b]:pos0[b] + C] for b in range(B)])

    jcache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, max_len)))
    tcache = P.tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                        P.init(None, tm.cache_specs(B, max_len), "cpu"))
    for pos0, nval in chunks:
        jlog, jcache = jm.prefill_chunk(jp, jnp.asarray(part(pos0)), jnp.asarray(pos0, jnp.int32),
                                        jnp.asarray(nval, jnp.int32), jcache)
        tlog, tcache = tm.prefill_chunk(tp, _t(part(pos0)).long(), _t(pos0), _t(nval), tcache)
        assert _rel(tlog[nval > 0], np.asarray(jlog)[nval > 0]) < REL
    pos = np.array([48, 48, 35], np.int32)
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    jlog, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jcache)
    tlog, tcache = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tcache)
    assert _rel(tlog, jlog) < REL
    assert [tuple(c["k"].shape[1:2]) for c in tcache] == [
        (32,) if k == "attn_local" else (max_len,) for k in tm.kinds]


# ---------------------------------------------------------- plain attention
@pytest.mark.parametrize("which", ["full", "chunk_global", "chunk_ring"])
def test_query_slices_are_bit_identical(which):
    """Slicing the queries of the plain attention paths changes no bit.  A
    slice of a single query row is held to 1e-6 instead: the CPU's BLAS
    takes another kernel for so small a product, whose f32 sums round
    differently."""
    rng = np.random.default_rng(5)
    B, C, H, W = 2, 40, 4, 16
    q = _t(rng.normal(size=(B, C, H, HD)).astype(np.float32))
    k = _t(rng.normal(size=(B, C, KV, HD)).astype(np.float32))
    v = _t(rng.normal(size=(B, C, KV, HD)).astype(np.float32))
    if which == "full":
        def run(qc):
            return L.attention_full(q, k, v, causal=True, window=W, q_chunk=qc)
    else:
        ring = which == "chunk_ring"
        pos0 = np.array([21, 3], np.int32)
        cache = _to_torch(_ring_cache(rng, B, W, fill_to=list(pos0)))
        if not ring:
            cache = {n: _t(rng.normal(size=(B, 64, KV, HD)).astype(np.float32))
                     for n in ("k", "v")}

        def run(qc):
            return L.attention_chunk(q, k, v, cache, _t(pos0), window=W if ring else 0,
                                     ring=ring, q_chunk=qc)
    whole = run(C)
    for qc in (2, 7, 16):
        assert torch.equal(run(qc), whole), qc
    assert _rel(run(1), whole) < 1e-6


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_unembed_slices_are_bit_identical(tied):
    """The vocabulary-sliced unembedding gives the logits of one product,
    bit for bit, for f32 and bf16 tables."""
    cfg = dataclasses.replace(get_config(GEMMA), tie_embeddings=tied)
    gen = torch.Generator().manual_seed(0)
    p = P.init(gen, L.embed_specs(cfg), "cpu")
    x = torch.randn((3, 1, cfg.d_model), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        pd = P.tree_map(lambda t: t.to(dt), p)
        xd = x.to(dt)
        w = pd["embedding"].float().t() if tied else pd["unembed"].float()
        whole = xd.float() @ w
        for rows in (100, 512, 1000):
            got = L.unembed_logits(pd, xd, cfg, rows=rows)
            assert got.dtype == torch.float32 and torch.equal(got, whole), (dt, rows)


# ----------------------------------------------------------------- flash
@pytest.mark.parametrize("window", [0, 32, 20])
def test_flash_plain_matches_reference_at_gemma3_heads(window):
    """The port's flash wrapper on CPU tensors (its plain version) against the
    reference's Pallas flash in interpret mode: two query heads a kv head,
    head_dim 128, windows of a tile, of none, and not a multiple of one."""
    rng = np.random.default_rng(window)
    B, S, H, KV_, d = 2, 96, 4, 2, 128
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, KV_, d)).astype(np.float32)
    v = rng.normal(size=(B, S, KV_, d)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     window=window, use_pallas=True, bq=32, bk=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert _rel(got, want) < 2e-5


# ---------------------------------------------------------------- engines
RING_ENGINE = dict(capacity=4, max_len=128, buckets=(16, 48))


def _ring_traffic(vocab):
    """Six requests on four rows: bucketed (16 and 48, the window of 32
    biting inside a 40-token prefill), decode past the wrap (30 + 8 tokens),
    two prompts chunked in chunks of 48 past the ring, which go last and
    reuse rows that finished."""
    rng = np.random.default_rng(3)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in (5, 40, 30, 12, 100, 60)]


def _serve(eng, make_req, make_sp, prompts, settle=None, new_tokens=8):
    for i, p in enumerate(prompts):
        eng.submit(make_req(rid=i, prompt=list(p),
                            sampling=make_sp(max_new_tokens=new_tokens)), now=0.0)
    t = 0.0
    while eng.pending() and t < 300:
        eng.step(now=t)
        if settle is not None:
            settle(eng)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}


def _engines(arch, kw, **cfg_kw):
    jcfg, tcfg = _cfgs(arch, **cfg_kw)
    np32, jp = _f32_params(jcfg)
    tp = P.from_jax(np32, tcfg)
    return ((lambda: JEngine(jcfg, params=jp, **kw)),
            (lambda: InferenceEngine(tcfg, params=tp, device="cpu", **kw)), tcfg)


def test_dense_engine_greedy_matches_reference():
    """gemma3-smoke on the dense backend (the only one for ring layers):
    identical greedy tokens, with chunks longer than the ring, decode past
    the wrap and two reused rows, whose ring positions are reset to -1."""
    make_ref, make_port, tcfg = _engines(GEMMA, RING_ENGINE)
    prompts = _ring_traffic(tcfg.vocab_size)
    ref = _serve(make_ref(), JRequest, JSamplingParams, prompts,
                 settle=lambda e: jax.block_until_ready(e.caches))
    eng = make_port()
    assert not eng.paged
    got = _serve(eng, Request, SamplingParams, prompts)
    assert len(got) == 6 and all(len(v) == 8 for v in got.values())
    assert got == ref
    assert sum(st.chunk_rows for st in eng.history) >= 3, "no prompt went chunked"
    ring = [c for c, k in zip(eng.caches, eng.model.kinds) if k == "attn_local"]
    assert ring and all(c["pos"].dtype == torch.int32 for c in ring)


def test_reused_row_is_reset_to_empty_ring():
    """A row that held a long prompt, reused by a prompt chunked in pieces
    shorter than the ring: after its first chunk the ring's positions equal
    the reference's, slot for slot (-1 where the chunk left a slot empty, so
    no slot of the previous occupant and no empty slot reads as position 0),
    and its greedy tokens equal the reference's."""
    make_ref, make_port, tcfg = _engines(GEMMA, dict(capacity=1, max_len=128,
                                                     buckets=(16,)))
    prompts = _ring_traffic(tcfg.vocab_size)

    def run(eng, make_req, make_sp, settle, ring_pos):
        _serve(eng, make_req, make_sp, [prompts[4]], settle)
        eng.submit(make_req(rid=1, prompt=list(prompts[5]),
                            sampling=make_sp(max_new_tokens=8)), now=0.0)
        eng.step(now=0.0)
        settle(eng)
        after_first = ring_pos(eng.caches)
        _serve(eng, make_req, make_sp, [], settle)
        return after_first, list(eng.finished[-1].output)

    kinds = make_model(tcfg).kinds
    local = [j for j, k in enumerate(kinds) if k == "attn_local"]
    want_pos, want = run(make_ref(), JRequest, JSamplingParams,
                         lambda e: jax.block_until_ready(e.caches),
                         lambda c: [np.asarray(c["blocks"][f"m{j}"]["pos"][0]) for j in local])
    got_pos, got = run(make_port(), Request, SamplingParams, lambda e: None,
                       lambda c: [c[j]["pos"].numpy().copy() for j in local])
    for g, w in zip(got_pos, want_pos):
        np.testing.assert_array_equal(g, w)
        assert (g == -1).sum() == 16 and sorted(g[g >= 0].tolist()) == list(range(16))
    assert got == want and len(got) == 8


@pytest.mark.parametrize("window", [32, 8])
def test_bucketed_prefill_exactness(window):
    """The same prompt through buckets (16,) and (32,) gives identical greedy
    tokens (the reference's test_engine_bucketed_prefill_exactness), with
    the window of the smoke config and one shorter than the prompt."""
    cfg = dataclasses.replace(get_config(GEMMA), local_window=window)
    prompt = [int(x) for x in np.random.default_rng(0).integers(0, cfg.vocab_size, 13)]
    outs = []
    for buckets in [(16,), (32,)]:
        eng = InferenceEngine(cfg, capacity=2, max_len=64, buckets=buckets, seed=5,
                              device="cpu")
        eng.submit(Request(rid=0, prompt=prompt, sampling=SamplingParams(max_new_tokens=5)))
        outs.append(eng.run(max_steps=40)[0].output)
    assert outs[0] == outs[1], outs


def test_mixtral_sliding_window_matches_reference():
    """mixtral-8x7b-smoke (window 64 over MoE layers): prefill and decode
    logits of an 80-token prompt, then dense-engine greedy tokens with a
    prompt past the window, against the reference."""
    jcfg, tcfg = _cfgs(MIXTRAL)
    assert tcfg.sliding_window == 64 and tcfg.num_experts
    np32, jp = _f32_params(jcfg)
    tp = P.from_jax(np32, tcfg)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    tm = make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32"))
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 80)).astype(np.int32)
    true = np.array([80, 70], np.int32)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 128, true_len=jnp.asarray(true))
    tlog, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, 128, true_len=_t(true))
    assert _rel(tlog, jlog) < REL
    assert all(c["k"].shape[1] == 64 and "pos" in c for c in tc)
    nxt, pos = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None], true
    for _ in range(2):
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tlog, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc)
        assert _rel(tlog, jlog) < REL
        nxt, pos = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None], pos + 1

    kw = dict(capacity=2, max_len=128, buckets=(16, 96))
    prompts = [[int(x) for x in toks[0]], [int(x) for x in toks[1, :20]]]
    ref = _serve(JEngine(jcfg, params=jp, **kw), JRequest, JSamplingParams, prompts,
                 settle=lambda e: jax.block_until_ready(e.caches), new_tokens=6)
    got = _serve(InferenceEngine(tcfg, params=tp, device="cpu", **kw), Request,
                 SamplingParams, prompts, new_tokens=6)
    assert got == ref and all(len(v) == 6 for v in got.values())


@pytest.mark.parametrize("arch", [a + s for a in ARCH_IDS for s in ("", "-smoke")])
def test_supports_paged_matches_reference(arch):
    ref = jax_make_model(jax_get_config(arch))
    # the reference's EncDec has no supports_paged: it serves dense only
    want = ref.supports_paged() if hasattr(ref, "supports_paged") else False
    assert make_model(get_config(arch)).supports_paged() == want
    if get_config(arch).window_for("attn") or get_config(arch).local_ratio:
        assert not want


# -------------------------------------------------------------- migration
def test_ring_row_migration_matches_reference():
    """extract_row/adopt of a decoding gemma3-smoke row between two dense
    engines, in both packages: the port's payload carries the ring's
    positions leaf for leaf as the reference's does (k/v within bf16's
    rounding), adoption decodes the unmigrated greedy tokens, and neither
    package can convert the payload to the paged layout."""
    kw = dict(capacity=2, max_len=96, buckets=(16, 48))
    make_ref, make_port, tcfg = _engines(GEMMA, kw)
    prompt = _ring_traffic(tcfg.vocab_size)[1]          # 40 tokens: the ring wraps

    def run(make, make_req, make_sp, settle):
        full = _serve(make(), make_req, make_sp, [prompt], settle, new_tokens=12)[0]
        a, b = make(), make()
        a.submit(make_req(rid=0, prompt=list(prompt),
                          sampling=make_sp(max_new_tokens=12)), now=0.0)
        t = 0.0
        while not a.row_req or len(next(iter(a.row_req.values())).output) < 5:
            a.step(now=t)
            settle(a)
            t += 1.0
        req, payload = a.extract_row(0, now=t)
        assert b.adopt(req, payload, now=t)
        assert not b.can_convert(a)
        while b.pending():
            b.step(now=t)
            settle(b)
            t += 1.0
        return full, list(b.finished[0].output), payload

    want_full, want_moved, jpay = run(make_ref, JRequest, JSamplingParams,
                                      lambda e: jax.block_until_ready(e.caches))
    full, moved, pay = run(make_port, Request, SamplingParams, lambda e: None)
    assert moved == full == want_full == want_moved
    assert pay["pos"] == jpay["pos"] > 32
    for i, layer in enumerate(pay["caches"]):
        ref = jpay["caches"]["blocks"][f"m{i % 6}"]
        assert set(layer) == set(ref)
        for n, t in layer.items():
            want = np.asarray(ref[n][i // 6], np.float32)
            if n == "pos":
                assert t.dtype == torch.int32
                np.testing.assert_array_equal(t.numpy(), want)
            else:
                np.testing.assert_allclose(t.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_serve_launcher_serves_gemma3_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3-27b",
         "--requests", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert "model gemma3-27b: state=ready" in out.stdout
