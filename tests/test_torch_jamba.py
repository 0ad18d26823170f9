"""The PyTorch port's hybrid stack (jamba) against the JAX reference, on the
CPU.

``jamba-v0.1-52b-smoke`` is one whole Jamba block of 8 layers: SSM layers
(8 heads of 16, state 16, ssm_chunk 32) with attention on layer 4 (4 query
heads over 1 kv head, no rope) and MoE (4 experts, top-2) on the odd
layers, dense MLPs on the even ones.  Weights are the reference's seeded
init carried across by ``from_jax`` in f32, with noise on the norm scales,
``dt_bias`` and ``A_log``; inputs come from numpy.  Each LM mode is held to
the same mode of the reference (MoE capacity is per call) within 1e-4 with
f32 KV, logits and every layer's cache.  The dense engine gives identical
greedy tokens over bucketed, chunked and reused rows (the reference engine
waits at the end of each step, see
tests/test_torch_control_plane.py::_settled), a reused row's SSM state and
KV after its first chunk equal the reference's, and a migrated row, SSM
state and KV together, resumes to the unmigrated tokens.
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
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "jamba-v0.1-52b-smoke"
REL = 1e-4
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    specs = jax_make_model(jcfg).param_specs()
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(k, specs))(jax.random.PRNGKey(0)))
    noise = np.random.default_rng(4)

    def f32(path, a):
        a = a.astype(np.float32)
        if path[-1].key in ("scale", "dt_bias", "A_log"):
            a = a + 0.3 * noise.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    return jcfg, tcfg, np32, jax.tree.map(jnp.asarray, np32), P.from_jax(np32, tcfg)


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


class _Jitted:
    """The reference model with its serving modes jitted (each shape traced
    once)."""

    def __init__(self, m):
        self.cache_specs = m.cache_specs
        self.prefill = jax.jit(m.prefill, static_argnums=(2,))
        self.prefill_chunk = jax.jit(m.prefill_chunk)
        self.decode_step = jax.jit(m.decode_step)


def _models(jcfg, tcfg, use_kernels=False):
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    return (_Jitted(jm), make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32",
                                                         use_kernels=use_kernels)))


def _jlayer(jtree, i):
    """Layer ``i`` of a reference tree stacked by the 8-layer group."""
    return jax.tree.map(lambda a: a[0], jtree["blocks"][f"m{i}"])


def _close_caches(tcaches, jcaches, rows=slice(None)):
    for i, tc in enumerate(tcaches):
        jc = _jlayer(jcaches, i)
        assert set(tc) == set(jc), i
        for n, t in tc.items():
            assert _rel(t[rows], np.asarray(jc[n])[rows]) < REL, (i, n)


def test_from_jax_carries_every_hybrid_leaf(setup):
    """Layer kinds and leaves: SSM mixers except at layer 4, MoE MLPs on the
    odd layers; every leaf bit for bit."""
    _, tcfg, np32, _, tp = setup
    m = make_model(tcfg)
    assert m.kinds == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert m.moes == [i % 2 == 1 for i in range(8)]
    assert not m.supports_paged()
    for i, layer in enumerate(tp["layers"]):
        assert ("router" in layer["mlp"]) == m.moes[i]
        assert ("A_log" in layer["mixer"]) == (m.kinds[i] == "ssm")
        want = jax.tree.map(lambda a: a[0], np32["blocks"][f"m{i}"])
        for got, ref in zip(P.tree_leaves(layer), jax.tree.leaves(want)):
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lm_prefill_matches_reference(setup, use_kernels):
    """A right-padded bucket of two scan chunks: logits at each row's last
    valid token, the SSM state stopped at true_len and the attention layer's
    KV (flash's plain version on the kernel path)."""
    jcfg, tcfg, _, jp, tp = setup
    jm, tm = _models(jcfg, tcfg, use_kernels)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (3, 64)).astype(np.int32)
    true = np.array([64, 40, 12], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 96, true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, 96, true_len=_t(true))
    assert _rel(tl, jl) < REL
    _close_caches(tc, jc)


def test_lm_chunk_and_decode_match_reference(setup):
    """prefill_chunk twice on a pool cache (row 2 idle in the first chunk;
    SSM layers skip the write slots), then three decode steps after a
    prefill, the last with a row that is not live and keeps every cache
    entry bit for bit."""
    jcfg, tcfg, _, jp, tp = setup
    jm, tm = _models(jcfg, tcfg)
    rng = np.random.default_rng(3)
    B, S, C, max_len = 3, 64, 32, 96
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)

    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, max_len)))
    tcache = P.tree_map(lambda t: t.float(), P.init(None, tm.cache_specs(B, max_len), "cpu"))
    for pos0, nval in ((np.array([0, 0, 0]), np.array([32, 32, 0])),
                       (np.array([32, 32, 0]), np.array([32, 11, 20]))):
        part = np.stack([toks[b, pos0[b]:pos0[b] + C] for b in range(B)])
        jl, jcache = jm.prefill_chunk(jp, jnp.asarray(part), jnp.asarray(pos0, jnp.int32),
                                      jnp.asarray(nval, jnp.int32), jcache)
        tl, tcache = tm.prefill_chunk(tp, _t(part).long(), _t(pos0), _t(nval), tcache)
        assert _rel(tl[nval > 0], np.asarray(jl)[nval > 0]) < REL
    _close_caches(tcache, jcache)

    true = np.array([64, 40, 12], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len, true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, max_len, true_len=_t(true))
    pos = true.copy()
    for step in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        live = np.array([True, True, step < 2])
        before = P.tree_map(lambda t: t.clone(), tc)
        jl, jnew = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc, live=_t(live))
        assert _rel(tl[:2], np.asarray(jl)[:2]) < REL
        _close_caches(tc, jnew, rows=live)
        for got, old in zip(P.tree_leaves(tc), P.tree_leaves(before)):
            assert torch.equal(got[~_t(live)], old[~_t(live)])
        # the reference has no live mask: keep its old entries on dead rows
        jc = jax.tree.map(lambda new, old: jnp.where(
            jnp.asarray(live).reshape((1, -1) + (1,) * (new.ndim - 2)), new, old), jnew, jc)
        pos = pos + live


# ---------------------------------------------------------------- engine
ENGINE_KW = dict(capacity=3, max_len=112, buckets=(16, 32))
MOVED = 1           # the request whose decoding row goes out and back in
REUSER = 3          # the request chunked into a row another one freed


def _traffic(vocab):
    """Bucketed (10, 25), chunked (70) beside decoding rows, and two more
    chunked (40, 33) that wait for rows and reuse them."""
    rng = np.random.default_rng(7)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in (10, 70, 25, 40, 33)]


def _run(eng, make_req, make_sp, settle, row_caches, move):
    """Serve the traffic greedily on a logical clock.  ``move``: once request
    ``MOVED`` has 3 tokens, extract its row (SSM state, conv tails and KV of
    every layer) and adopt it back, as a migration does.  Returns (tokens by
    rid, the reused row's caches right after ``REUSER``'s first chunk, the
    migration payload, the engine)."""
    for i, p in enumerate(_traffic(eng.cfg.vocab_size)):
        eng.submit(make_req(rid=i, prompt=p, sampling=make_sp(max_new_tokens=6)), now=0.0)
    reused = payload = None
    t = 0.0
    while eng.pending() and t < 300:
        eng.step(now=t)
        settle(eng)
        rows = {q.rid: row for row, q in eng._prefilling.items()}
        if reused is None and REUSER in rows:
            reused = row_caches(eng.caches, rows[REUSER])
        live = {q.rid: q for q in eng.row_req.values()}
        if move and payload is None and MOVED in live and len(live[MOVED].output) >= 3:
            req, payload = eng.extract_row(MOVED, now=t)
            assert eng.adopt(req, payload, now=t)
            settle(eng)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}, reused, payload, eng


@pytest.fixture(scope="module")
def served(setup):
    """One reference engine (its device work awaited after every step) and
    two port engines, on the dense backend, over the same traffic: the
    reference's and one port run move request ``MOVED``'s row out and back
    in; the other port run leaves it."""
    jcfg, tcfg, _, jp, tp = setup
    ref = _run(JEngine(jcfg, params=jp, **ENGINE_KW), JRequest, JSamplingParams,
               lambda e: jax.block_until_ready(e.caches),
               lambda c, row: [jax.tree.map(lambda a: np.asarray(a[0, row]),
                                            c["blocks"][f"m{i}"]) for i in range(8)],
               move=True)

    def port(move):
        eng = InferenceEngine(tcfg, params=tp, kv_backend="paged", device="cpu",
                              **ENGINE_KW)
        return _run(eng, Request, SamplingParams, lambda e: None,
                    lambda c, row: [{n: t[row].clone() for n, t in layer.items()}
                                    for layer in c], move)

    return ref, port(False), port(True)


def test_engine_greedy_matches_reference(served):
    """Dense serving (the engine keeps it for SSM state even when asked for
    the paged backend): identical greedy tokens, with a chunk step beside
    decoding rows and reused rows."""
    ref, (got, _, _, eng), _ = served
    assert not eng.paged
    assert len(got) == 5 and all(len(v) == 6 for v in got.values())
    assert got == ref[0]
    assert any(st.chunk_rows and st.tokens_out for st in eng.history), \
        "a chunk step should overlap decode"


def test_reused_row_is_reset(served):
    """Request ``REUSER`` is chunked into the row request 0 freed: after its
    first chunk the row's SSM state, conv tails and KV equal the
    reference's, and the KV past the chunk is empty (nothing of the first
    occupant leaks)."""
    (_, want, _, _), (_, got, _, eng), _ = served
    chunk = eng.chunk
    for i, (layer, ref) in enumerate(zip(got, want)):
        assert set(layer) == set(ref)
        for n, t in layer.items():
            r = np.asarray(ref[n], np.float32)
            if t.dtype == torch.bfloat16:    # the pool's KV and conv tails
                np.testing.assert_allclose(t.float().numpy(), r, rtol=1e-2, atol=1e-2)
            else:
                assert _rel(t, r) < REL, (i, n)
            if n in ("k", "v"):
                assert not t[chunk:].any() and t[:chunk].any()


def test_hybrid_row_migration_matches_reference(served):
    """extract_row/adopt of a decoding hybrid row in both packages: the
    payload carries every layer's SSM state, conv tails and KV leaf for leaf
    as the reference's does, it cannot be converted to the paged layout, and
    the adopted row decodes the tokens of the run that did not move it."""
    (want, _, jpay, _), (plain, _, _, eng), (moved, _, pay, _) = served
    assert pay is not None and pay["kind"] == "dense"
    assert moved == plain == want
    assert pay["pos"] == jpay["pos"] > 70
    assert not eng.can_convert(eng)
    for i, layer in enumerate(pay["caches"]):
        ref = _jlayer(jpay["caches"], i)
        assert set(layer) == set(ref)
        for n, t in layer.items():
            assert t.shape[0] == 1
            np.testing.assert_allclose(t.float().numpy(), np.asarray(ref[n], np.float32),
                                       rtol=1e-2, atol=1e-2)


def test_serve_launcher_serves_jamba_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "jamba-v0.1-52b",
         "--requests", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert "model jamba-v0.1-52b: state=ready" in out.stdout
