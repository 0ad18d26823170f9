"""The PyTorch port's gemma family (gemma-2b, gemma3-4b) and its vision
prefix (paligemma-3b) against the JAX reference, on the CPU.

``gemma-2b-smoke`` is an MQA decoder (4 query heads over one kv head) with
GeGLU and a scaled, tied embedding; ``gemma3-4b-smoke`` one period of
gemma3's five local layers (window 32) and one global; ``paligemma-3b-smoke``
gemma-2b's backbone with 8 patch embeddings before the text under a
prefix-LM mask.  The smoke configs have head_dim 16; each runs again at the
family's head_dim of 256 and 2 layers.  Weights fill the reference's
parameter tree in f32, drawn with numpy by its init rules, and are carried
across by ``from_jax``, with nonzero norm scales; inputs, patches included,
come from numpy.  Logits within 1e-4 with f32 KV; engines to identical
greedy tokens (the reference engine waits at the end of each step, see
tests/test_torch_control_plane.py::_settled).
"""
import dataclasses
import functools
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
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams, State

GEMMA = "gemma-2b-smoke"
GEMMA3 = "gemma3-4b-smoke"
PALI = "paligemma-3b-smoke"
HD256 = dict(head_dim=256, num_layers=2)
REL = 1e-4
REPO = Path(__file__).resolve().parents[1]


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _f32_params(jcfg, seed=4):
    """The reference's parameter tree in f32, drawn with numpy by the
    reference's init rules (``repro.models.params.init``: std scale /
    sqrt(fan-in) from the second-to-last unstacked dim), with nonzero norm
    scales: (numpy tree, jnp tree), drawn once for each config.  numpy in
    place of the reference's per-leaf jax.random keeps a one-core run of
    this file short."""
    rng = np.random.default_rng(seed)

    def draw(path, sp):
        if sp.init in ("zeros", "ones", "const"):
            a = np.full(sp.shape, {"zeros": 0.0, "ones": 1.0}.get(sp.init, sp.scale),
                        np.float32)
        else:
            core = [n for n, ax in zip(sp.shape, sp.axes) if ax != "layers"]
            fan_in = core[-2] if len(core) >= 2 else core[-1]
            std = sp.scale if sp.init in ("embed", "normal") else sp.scale / np.sqrt(fan_in)
            a = (rng.normal(size=sp.shape) * std).astype(np.float32)
        if path[-1].key == "scale":
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(
        draw, jax_make_model(jcfg).param_specs(), is_leaf=JP.is_spec)
    return np32, jax.tree.map(jnp.asarray, np32)


def _patches(rng, B, cfg, std=0.5):
    return rng.normal(0, std, (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- LM modes
class _Jitted:
    """The reference model's modes under ``jax.jit``: one compile a shape,
    where eager dispatch pays for every op on every call."""

    def __init__(self, m):
        self.cfg = m.cfg
        self.prefill = jax.jit(m.prefill, static_argnums=(2,))
        for name in ("decode_step", "prefill_chunk", "prefill_chunk_paged",
                     "decode_step_paged"):
            setattr(self, name, jax.jit(getattr(m, name)))
        self.cache_specs, self.paged_cache_specs = m.cache_specs, m.paged_cache_specs


MODELS = [(GEMMA, {}), (GEMMA, HD256), (GEMMA3, {}), (GEMMA3, HD256), (PALI, {}),
          (PALI, HD256)]


@pytest.fixture(scope="module", params=MODELS,
                ids=[a.split("-smoke")[0] + ("_hd256" if kw else "") for a, kw in MODELS])
def model(request):
    arch, kw = request.param
    jcfg, tcfg = _cfgs(arch, **kw)
    np32, jp = _f32_params(jcfg)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    tm = make_model(tcfg, with_overrides(BASELINE, kv_dtype="float32", q_chunk=16))
    return _Jitted(jm), tm, jp, P.from_jax(np32, tcfg)


def _decode(jm, tm, jp, tp, jc, tc, pos, jlog, steps=1):
    """Greedy decode steps of both models from the reference's logits."""
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    for _ in range(steps):
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tlog, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc)
        assert _rel(tlog, jlog) < REL
        nxt, pos = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None], pos + 1


def _chunks(jm, tm, jp, tp, toks, chunks, C, max_len, paged=None):
    """Chunked prefill of ``toks`` in the given (pos0, n_valid) steps, on a
    pool cache, or on paged pools through ``paged`` = (table, num_blocks,
    block_size); returns the last logits of both."""
    B = toks.shape[0]

    def part(pos0):
        return np.stack([np.pad(toks[b, pos0[b]:pos0[b] + C],
                                (0, max(0, pos0[b] + C - toks.shape[1])))
                         for b in range(B)])

    if paged is None:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, max_len)))
        tc = P.tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                        P.init(None, tm.cache_specs(B, max_len), "cpu"))
    else:
        table, nb, bs = paged
        jc = JP.init(jax.random.PRNGKey(0), jm.paged_cache_specs(nb, bs))
        tc = P.init(None, tm.paged_cache_specs(nb, bs), "cpu")
    for pos0, nval in chunks:
        args = (jnp.asarray(part(pos0)), jnp.asarray(pos0, jnp.int32),
                jnp.asarray(nval, jnp.int32), jc)
        targs = (_t(part(pos0)).long(), _t(pos0), _t(nval), tc)
        if paged is None:
            jlog, jc = jm.prefill_chunk(jp, *args)
            tlog, tc = tm.prefill_chunk(tp, *targs)
        else:
            jlog, jc = jm.prefill_chunk_paged(jp, *args, jnp.asarray(table))
            tlog, tc = tm.prefill_chunk_paged(tp, *targs, _t(table))
        assert _rel(tlog[nval > 0], np.asarray(jlog)[nval > 0]) < REL
    return jlog, tlog, jc, tc


def test_lm_modes_match_reference(model):
    """Every mode of the family against the same mode of the reference.
    All: bucketed prefill (true_len) then decode.  Text models: two chunks
    on a pool cache with an idle row, then decode.  gemma-2b: two paged
    chunks, then paged decode with a dead row.  gemma3: prompts past the
    window of 32.  paligemma: nonzero patches before the text, decode at
    positions that count them."""
    jm, tm, jp, tp = model
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    B, S, max_len, V = 3, 40, 96, cfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    true = np.array([40, 29, 9], np.int32)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    prefix = cfg.num_vision_tokens
    if prefix:
        patches = _patches(rng, B, cfg)
        batch_j["patches"], batch_t["patches"] = jnp.asarray(patches), _t(patches)
    jlog, jc = jm.prefill(jp, batch_j, max_len, true_len=jnp.asarray(true))
    tlog, tc = tm.prefill(tp, batch_t, max_len, true_len=_t(true))
    assert _rel(tlog, jlog) < REL
    _decode(jm, tm, jp, tp, jc, tc, true + prefix, jlog)
    if prefix:
        assert not tm.supports_paged()
        # the patches move the logits: the prefix is attended, not skipped
        zero = tm.prefill(tp, dict(batch_t, patches=torch.zeros_like(batch_t["patches"])),
                          max_len, true_len=_t(true))[0]
        assert _rel(zero, tlog.numpy()) > 1e-3
        return

    C = 24
    chunks = [(np.array([0, 0, 0]), np.array([24, 20, 0])),
              (np.array([24, 20, 0]), np.array([16, 20, 9]))]
    jlog, _, jc, tc = _chunks(jm, tm, jp, tp, toks, chunks, C, max_len)
    _decode(jm, tm, jp, tp, jc, tc, np.array([40, 40, 9], np.int32), jlog)
    if not tm.supports_paged():
        return
    nb, bs, max_blk = 32, 4, 12
    table = np.full((B, max_blk), -1, np.int32)
    perm = np.random.default_rng(3).permutation(nb)
    table[0, :11], table[1, :11], table[2, :3] = perm[:11], perm[11:22], perm[22:25]
    jlog, tlog, jpools, tpools = _chunks(jm, tm, jp, tp, toks, chunks, C, max_len,
                                         paged=(table, nb, bs))
    pos, live = np.array([40, 40, 9], np.int32), np.array([True, True, False])
    nxt = np.asarray(tlog).argmax(-1)[:, None].astype(np.int32)
    jlog, _ = jm.decode_step_paged(jp, jnp.asarray(nxt), jnp.asarray(pos), jpools,
                                   jnp.asarray(table), jnp.asarray(live))
    tlog, _ = tm.decode_step_paged(tp, _t(nxt).long(), _t(pos).long(), tpools,
                                   _t(table), _t(live))
    assert _rel(tlog, jlog) < REL


def test_from_jax_carries_gemma3_4b_tail_layers():
    """gemma3-4b's 34 layers are five periods of six and a tail of four,
    t30..t33 in the reference's tree (local, local, local, local): at smoke
    widths and full depth every leaf lands, in its layer."""
    jcfg, tcfg = _cfgs(GEMMA3, num_layers=jax_get_config("gemma3-4b").num_layers)
    np32, _ = _f32_params(jcfg)
    tp = P.from_jax(np32, tcfg)
    tm = make_model(tcfg)
    assert len(P.tree_leaves(tp)) == len(P.tree_leaves(tm.param_specs()))
    assert sorted(np32["tail"]) == [f"t{i}" for i in range(30, 34)]
    for i in range(30, 34):
        assert tm.kinds[i] == jcfg.layer_kind(i) == "attn_local"
        for n in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(tp["layers"][i]["mixer"][n].numpy(),
                                          np32["tail"][f"t{i}"]["mixer"][n])
    np.testing.assert_array_equal(tp["layers"][29]["mixer"]["wq"].numpy(),
                                  np32["blocks"]["m5"]["mixer"]["wq"][4])
    assert tm.kinds.count("attn") == 5 and tm.kinds.count("attn_local") == 29


# ---------------------------------------------------------- plain attention
@pytest.mark.parametrize("prefix", [11, 16])
def test_prefix_mask_across_query_slices(prefix):
    """The prefix-LM mask with a prefix that crosses the query slices of 8
    (11) or ends on one (16): against the reference's ``attention_full``
    over every key (its prefill's ``attn_impl="full"``), and bit for bit the
    same however the queries are sliced."""
    rng = np.random.default_rng(prefix)
    B, S, H, KV, d = 2, 30, 4, 1, 16
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, d)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, d)).astype(np.float32)
    want = JL.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             prefix_len=prefix, q_chunk=8, impl="full")
    got = L.attention_full(_t(q), _t(k), _t(v), causal=True, prefix_len=prefix, q_chunk=8)
    assert _rel(got, want) < 1e-6
    for qc in (2, 11, S):
        assert torch.equal(L.attention_full(_t(q), _t(k), _t(v), causal=True,
                                            prefix_len=prefix, q_chunk=qc), got), qc
    # prefix rows see the later prefix keys; text rows attend causally
    plain = L.attention_full(_t(q), _t(k), _t(v), causal=True, q_chunk=8)
    assert not torch.equal(plain[:, :prefix - 1], got[:, :prefix - 1])
    assert torch.equal(plain[:, prefix - 1:], got[:, prefix - 1:])


@pytest.mark.parametrize("window", [0, 40])
def test_flash_plain_matches_reference_at_head_dim_256(window):
    """The port's flash wrapper on CPU tensors (its plain version) against the
    reference's Pallas flash in interpret mode at head_dim 256: eight query
    heads over one kv head (gemma-2b) and over four (gemma3-4b, windowed)."""
    rng = np.random.default_rng(window)
    B, S, H, KV, d = 1, 96, 8, 4 if window else 1, 256
    q = rng.normal(size=(B, S, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, d)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, d)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     window=window, use_pallas=True, bq=32, bk=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert _rel(got, want) < 2e-5


# ---------------------------------------------------------------- engines
def _serve(eng, make_req, make_sp, prompts, settle=None, new_tokens=5, extras=None):
    for i, p in enumerate(prompts):
        eng.submit(make_req(rid=i, prompt=list(p), sampling=make_sp(max_new_tokens=new_tokens),
                            extras=dict((extras or {}).get(i, {}))), now=0.0)
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
    return ((lambda **k: JEngine(jcfg, params=jp, **kw, **k)),
            (lambda **k: InferenceEngine(tcfg, params=tp, device="cpu", **kw, **k)), tcfg)


def _settle(eng):
    jax.block_until_ready(eng.caches)


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in lens]


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_gemma_2b_engine_greedy_matches_reference(backend):
    """gemma-2b-smoke (MQA) on both backends, one prompt chunked."""
    kw = dict(capacity=3, max_len=64, buckets=(16,), block_size=8, kv_backend=backend)
    make_ref, make_port, tcfg = _engines(GEMMA, kw)
    prompts = _prompts(tcfg.vocab_size, (5, 11, 40, 14))
    ref = _serve(make_ref(), JRequest, JSamplingParams, prompts, settle=_settle)
    eng = make_port()
    assert eng.paged == (backend == "paged")
    got = _serve(eng, Request, SamplingParams, prompts)
    assert len(got) == 4 and all(len(v) == 5 for v in got.values())
    assert got == ref
    assert any(st.chunk_rows for st in eng.history), "no prompt went chunked"


def test_gemma3_4b_engine_greedy_matches_reference():
    """gemma3-4b-smoke on the dense backend: a bucketed prompt past the
    window, decode past the ring's wrap, a prompt chunked past the ring on
    a reused row."""
    kw = dict(capacity=2, max_len=96, buckets=(48,))
    make_ref, make_port, tcfg = _engines(GEMMA3, kw)
    prompts = _prompts(tcfg.vocab_size, (28, 40, 70))
    ref = _serve(make_ref(), JRequest, JSamplingParams, prompts, settle=_settle,
                 new_tokens=8)
    eng = make_port()
    got = _serve(eng, Request, SamplingParams, prompts, new_tokens=8)
    assert len(got) == 3 and all(len(v) == 8 for v in got.values())
    assert got == ref
    assert any(st.chunk_rows for st in eng.history), "no prompt went chunked"


def test_paligemma_engine_greedy_matches_reference():
    """paligemma-3b-smoke, the counterpart of tests/test_engine.py's
    test_engine_serves_vlm: requests with ``extras["patches"]`` and one
    without (zeros), two bucket groups, a reused row; identical greedy
    tokens, decode positions past the prefix, no chunked admission.  The
    paged backend falls back to dense."""
    kw = dict(capacity=2, max_len=48, buckets=(8, 16))
    make_ref, make_port, tcfg = _engines(PALI, kw)
    rng = np.random.default_rng(7)
    prompts = _prompts(tcfg.vocab_size, (7, 16, 3, 12))
    extras = {i: {"patches": _patches(rng, 1, tcfg, std=0.02)} for i in (0, 1, 3)}
    ref = _serve(make_ref(), JRequest, JSamplingParams, prompts, settle=_settle,
                 new_tokens=4, extras=extras)
    eng = make_port(kv_backend="paged")
    assert not eng.paged and not eng.model.supports_paged()
    got = _serve(eng, Request, SamplingParams, prompts, new_tokens=4, extras=extras)
    assert len(got) == 4 and all(len(v) == 4 for v in got.values())
    assert got == ref
    assert not any(st.chunk_rows for st in eng.history)
    assert int(eng.pos.max()) <= tcfg.num_vision_tokens + 16 + 4


def test_paligemma_rejects_prompts_past_the_largest_bucket():
    """The counterpart of tests/test_prefill_pipeline.py's
    test_oversized_prompt_rejected_not_crashed: a vision-prefix family
    cannot chunk, so a prompt longer than the largest bucket bounces; so
    does one past max_len - 1 - prefix."""
    cfg = get_config(PALI)
    eng = InferenceEngine(cfg, capacity=2, max_len=48, buckets=(8,), seed=1, device="cpu")
    req = Request(rid=0, prompt=[1] * 20)
    assert not eng.submit(req)
    assert req.state is State.REJECTED and eng.rejected_long == 1
    assert eng.submit(Request(rid=1, prompt=[1] * 8))
    wide = InferenceEngine(cfg, capacity=2, max_len=24, buckets=(8, 16), seed=1,
                           device="cpu")
    over = Request(rid=2, prompt=[1] * 16)          # > 24 - 1 - 8
    assert not wide.submit(over) and over.state is State.REJECTED
    assert wide.submit(Request(rid=3, prompt=[1] * 15))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-4b", "paligemma-3b"])
def test_serve_launcher_serves_the_family_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--requests", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert f"model {arch}: state=ready" in out.stdout
