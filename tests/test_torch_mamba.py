"""The PyTorch port's Mamba-2 path against the JAX reference, on the CPU.

``mamba2-780m-smoke`` (2 SSM layers, 8 heads of 16, state 16, ssm_chunk
32) with the reference's seeded init in f32 through ``from_jax``, plus
noise on the norm scales, ``dt_bias`` and ``A_log`` so the test sees them.
Prompts of 64 tokens take two chunks, so the state carry runs.  The SSD
layer in every mode, then the LM's modes with the scan kernel op on (its
plain version on the CPU) and off: outputs, logits and caches within
rel 1e-4.  Then the dense engine: greedy tokens and per-step counters
equal to the reference's over bucketed, chunked and reused rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.models import mamba as JM
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.models import mamba as M
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "mamba2-780m-smoke"
REL = 1e-4
CACHE_KEYS = ("h", "conv_x", "conv_B", "conv_C")


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
    jparams = jax.tree.map(jnp.asarray, np32)
    tparams = P.from_jax(np32, tcfg)
    return jcfg, tcfg, raw, jparams, tparams


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["blocks"]["m0"])


def _jcache(jc, i):
    return {n: jc["blocks"]["m0"][n][i] for n in CACHE_KEYS}


def _close_caches(tc, jc):
    for n in CACHE_KEYS:
        assert _rel(tc[n], jc[n]) < REL, n


# ------------------------------------------------------------ parameters
def test_from_jax_round_trips_every_leaf(setup):
    """Every leaf, SSD f32 vectors and zero-width MLP leaves included,
    arrives bit-identical and unstacked per layer."""
    _, tcfg, raw, _, _ = setup
    params = P.from_jax(raw, tcfg)
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(raw):
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        bits = leaf.view(np.uint16) if leaf.dtype.name == "bfloat16" else leaf
        for i in range(tcfg.num_layers) if keys[0] == "blocks" else [None]:
            t = params["layers"][i] if i is not None else params
            for k in keys[2:] if i is not None else keys:
                t = t[k]
            ref = bits[i] if i is not None else bits
            got = (t.view(torch.int16).numpy().view(np.uint16)
                   if t.dtype == torch.bfloat16 else t.numpy())
            assert got.shape == ref.shape and got.dtype == ref.dtype, keys
            np.testing.assert_array_equal(got, ref)
            n += 1
    specs = P.tree_leaves(make_model(tcfg).param_specs())
    assert n == len(specs)
    assert any(0 in s.shape for s in specs), "d_ff = 0 gives zero-width MLP leaves"


def test_port_init_uses_the_contracted_fan_in():
    """Full-width random weights: std 1/sqrt(D) for the input projections
    (the reference's rule gives w_B/w_C std 1 at G = 1) and 1/sqrt(H*P) for
    w_out."""
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=1, vocab_size=8)
    specs = make_model(cfg).param_specs()
    params = P.init(torch.Generator().manual_seed(0), specs, "cpu")
    mix = params["layers"][0]["mixer"]
    D, HP = cfg.d_model, cfg.ssm_nheads * cfg.ssm_headdim
    for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"):
        assert abs(mix[name].float().std().item() * D ** 0.5 - 1) < 0.05, name
    assert abs(mix["w_out"].float().std().item() * HP ** 0.5 - 1) < 0.05


# ----------------------------------------------------------------- layer
@pytest.mark.parametrize("S", [64, 50])
def test_ssd_layer_modes_match_reference(setup, S):
    """ssd_apply_full with and without true_len (S = 50 front-pads to a
    chunk multiple), with the scan kernel op and without; then a chunk
    with an idle row, and a decode step with a row that is not live."""
    jcfg, tcfg, _, jp, tp = setup
    jl, tl = _layer(jp, 0)["mixer"], tp["layers"][0]["mixer"]
    rng = np.random.default_rng(1)
    B, D = 3, tcfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    true = np.array([S, 40, 7], np.int32)

    ref, _ = JM.ssd_apply_full(jl, x, jcfg)
    got, _ = M.ssd_apply_full(tl, _t(x), tcfg)
    assert _rel(got, ref) < REL
    for use_kernels in (False, True):
        ref, jc = JM.ssd_apply_full(jl, x, jcfg, want_state=True,
                                    true_len=jnp.asarray(true),
                                    use_pallas=use_kernels, interpret=True)
        got, tc = M.ssd_apply_full(tl, _t(x), tcfg, want_state=True,
                                   true_len=_t(true), use_kernels=use_kernels)
        for b in range(B):
            assert _rel(got[b, :true[b]], np.asarray(ref)[b, :true[b]]) < REL
        _close_caches(tc, jc)

    # chunk of 32 on top of that state; row 1 idles (true_len 0)
    xc = rng.normal(size=(B, 32, D)).astype(np.float32)
    n_valid = np.array([32, 0, 19], np.int32)
    ref, jc2 = JM.ssd_apply_chunk(jl, xc, jc, jcfg, true_len=jnp.asarray(n_valid))
    before = {n: t.clone() for n, t in tc.items()}
    got = M.ssd_apply_chunk(tl, _t(xc), tc, tcfg, true_len=_t(n_valid))
    for b in (0, 2):
        assert _rel(got[b, :n_valid[b]], np.asarray(ref)[b, :n_valid[b]]) < REL
    _close_caches(tc, jc2)
    for n in CACHE_KEYS:
        assert torch.equal(tc[n][1], before[n][1]), f"idle row changed {n}"

    # one decode step; row 2 is not live
    xd = rng.normal(size=(B, 1, D)).astype(np.float32)
    ref, jc3 = JM.ssd_apply_decode(jl, xd, jc2, jcfg)
    before = {n: t.clone() for n, t in tc.items()}
    got = M.ssd_apply_decode(tl, _t(xd), tc, tcfg, live=torch.tensor([True, True, False]))
    assert _rel(got, ref) < REL
    for n in CACHE_KEYS:
        assert _rel(tc[n][:2], np.asarray(jc3[n])[:2]) < REL, n
        assert torch.equal(tc[n][2], before[n][2]), f"dead row changed {n}"


# ------------------------------------------------------------- LM modes
@pytest.mark.parametrize("use_kernels", [True, False])
def test_lm_prefill_matches_reference(setup, use_kernels):
    """Bucketed prefill of right-padded rows: logits and every layer's
    state, against the reference with its Pallas kernel (interpret mode)
    or its plain scan."""
    jcfg, tcfg, _, jp, tp = setup
    jm = jax_make_model(jcfg, dataclasses.replace(
        JBASELINE, use_pallas=use_kernels, pallas_interpret=True))
    tm = make_model(tcfg, with_overrides(BASELINE, use_kernels=use_kernels))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (3, 64)).astype(np.int32)
    true = np.array([64, 45, 9], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 96, true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, 96, true_len=_t(true))
    assert tl.dtype == torch.float32 and _rel(tl, jl) < REL
    for i in range(tcfg.num_layers):
        _close_caches(tc[i], _jcache(jc, i))


def test_lm_chunk_and_decode_match_reference(setup):
    """prefill_chunk twice on a pool cache (row 2 idle in the first chunk),
    then three decode_steps after a prefill, the last with a row that is
    not live: logits and every layer's state."""
    jcfg, tcfg, _, jp, tp = setup
    jm, tm = jax_make_model(jcfg), make_model(tcfg)
    rng = np.random.default_rng(3)
    B, S, C, V = 3, 64, 32, tcfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)

    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, 96)))
    tcache = P.tree_map(lambda t: t.float(), P.init(None, tm.cache_specs(B, 96), "cpu"))
    for pos0, nval in ((np.array([0, 0, 0]), np.array([32, 32, 0])),
                       (np.array([32, 32, 0]), np.array([32, 11, 20]))):
        part = np.stack([toks[b, pos0[b]:pos0[b] + C] for b in range(B)])
        jl, jcache = jm.prefill_chunk(jp, jnp.asarray(part), jnp.asarray(pos0, jnp.int32),
                                      jnp.asarray(nval, jnp.int32), jcache)
        tl, tcache = tm.prefill_chunk(tp, _t(part).long(), _t(pos0), _t(nval), tcache)
        assert _rel(tl[nval > 0], np.asarray(jl)[nval > 0]) < REL
    for i in range(tcfg.num_layers):
        _close_caches(tcache[i], _jcache(jcache, i))

    true = np.array([64, 40, 12], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 96, true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, 96, true_len=_t(true))
    pos = true.copy()
    for step in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        live = np.array([True, True, step < 2])
        before = [dict(c) for c in P.tree_map(lambda t: t.clone(), tc)]
        jl, jnew = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc,
                                live=_t(live))
        assert _rel(tl[:2], np.asarray(jl)[:2]) < REL
        for i in range(tcfg.num_layers):
            for n in CACHE_KEYS:
                ref = np.asarray(jnew["blocks"]["m0"][n][i])
                assert _rel(tc[i][n][live], ref[live]) < REL, (step, n)
                if not live.all():
                    assert torch.equal(tc[i][n][~live], before[i][n][~live])
        jc = jax.tree.map(lambda new, old: jnp.where(
            jnp.asarray(live).reshape((1, -1) + (1,) * (new.ndim - 2)), new, old), jnew, jc)
        pos = pos + live


# ---------------------------------------------------------------- engine
ENGINE_KW = dict(capacity=3, max_len=112, buckets=(16, 32))


def _prompts():
    rng = np.random.default_rng(7)

    def toks(n):
        return [int(x) for x in rng.integers(0, 512, n)]

    # wave 1: bucketed (10, 25), chunked (70) while the others decode, and
    # a fourth (40, chunked) that waits for a row and reuses it; wave 2
    # (after wave 1 retired) reuses rows again
    return [toks(10), toks(70), toks(25), toks(40)], [toks(5), toks(33)]


def _serve(eng, make_req, make_sp):
    wave1, wave2 = _prompts()
    for i, p in enumerate(wave1):
        eng.submit(make_req(rid=i, prompt=p, sampling=make_sp(max_new_tokens=6)), now=0.0)
    stats, events, t, submitted2 = [], [], 0.0, False
    while t < 300:
        if not eng.pending():
            if submitted2:
                break
            for i, p in enumerate(wave2):
                eng.submit(make_req(rid=100 + i, prompt=p,
                                    sampling=make_sp(max_new_tokens=6)), now=t)
            submitted2 = True
        st = eng.step(now=t)
        stats.append((st.prefill_tokens, st.chunk_rows, st.tokens_out, st.n_prefill,
                      st.occupancy, st.prefill_tokens_padded))
        events.extend((type(e).__name__, dataclasses.asdict(e)) for e in st.events)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}, stats, events


def test_engine_matches_reference(setup):
    """Greedy serving on the dense backend: same tokens, same per-step
    counters and events.  The trace has a chunked prompt advancing while
    other rows decode (the live mask) and chunked prompts on reused rows
    (the fresh-row reset)."""
    jcfg, tcfg, _, jp, tp = setup
    jeng = JEngine(jcfg, params=jp, **ENGINE_KW)
    teng = InferenceEngine(tcfg, params=tp, device="cpu", **ENGINE_KW)
    ref = _serve(jeng, JRequest, JSamplingParams)
    got = _serve(teng, Request, SamplingParams)
    assert len(got[0]) == 6
    assert any(s[1] and s[2] for s in got[1]), "a chunk step should overlap decode"
    assert got[0] == ref[0], "greedy outputs differ"
    assert got[1] == ref[1], "StepStats counters differ"
    assert got[2] == ref[2], "event streams differ"


def test_paged_request_runs_dense(setup):
    """No paged backend for SSM state: the engine keeps the dense one, as
    the reference's does, and serves the request."""
    jcfg, tcfg, _, jp, tp = setup
    assert JEngine(jcfg, params=jp, kv_backend="paged", **ENGINE_KW).paged is False
    eng = InferenceEngine(tcfg, params=tp, kv_backend="paged", device="cpu", **ENGINE_KW)
    assert eng.paged is False and not eng.model.supports_paged()
    eng.submit(Request(rid=0, prompt=list(range(1, 21)),
                       sampling=SamplingParams(max_new_tokens=4)))
    done = eng.run(max_steps=20)
    assert len(done) == 1 and len(done[0].output) == 4
