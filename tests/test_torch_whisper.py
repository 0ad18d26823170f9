"""The PyTorch port's encoder-decoder (whisper) against the JAX reference, on
the CPU.

``whisper-small-smoke``: 2 encoder and 2 decoder layers, 4 heads of 16
(MHA), 24 encoder frames, LayerNorm, the biased GELU MLP, learned
positions, a tied embedding.  Weights are the reference's seeded init
carried across by ``from_jax`` in f32, with noise on the LayerNorm scales
and biases and on the MLP biases; frames and tokens come from numpy.  The
encoder, prefill and decode are held to the reference within 1e-4 (the
encoder adds frames and positions in bf16 in both); the dense engine gives
identical greedy tokens with ``extras["frames"]`` (the reference engine
waits at the end of each step, see
tests/test_torch_control_plane.py::_settled), and a migrated row, self-KV
and cross-KV together, resumes to the unmigrated tokens.
"""
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
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.models.whisper import EncDec
from repro_torch.serving import InferenceEngine, Request, SamplingParams

ARCH = "whisper-small-smoke"
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
        if path[-1].key in ("scale", "bias", "b_in", "b_out"):
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    return jcfg, tcfg, np32, jax.tree.map(jnp.asarray, np32), P.from_jax(np32, tcfg)


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _frames(cfg, rng, n=1):
    return rng.normal(0, 0.02, (n, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _unrolled_encode(m):
    """The reference's ``EncDec.encode`` with its ``lax.scan`` over layers
    unrolled, the body as the reference writes it, run op by op on the host
    (``jax.pure_callback``) wherever it is called from, jitted code too.

    Unrolled: under f32 weights the reference's scan refuses its own carry
    (x enters as bf16, the frames' cast, and leaves the first layer as f32,
    bf16 + f32 promoting), so the reference cannot encode at f32 at all.
    Op by op: the frames' sum and the first layer's norm are rounded to
    bf16, and XLA's fusion of the unrolled body under ``jit`` moves the f32
    values before those roundings by a last bit, which flips single bf16
    roundings by an ulp; the encoder's attention carries that to the
    output.  Op by op every rounding is the reference's as written."""
    cfg, perf = m.cfg, m.perf

    def body(params, frames):
        x = frames.astype(jnp.bfloat16) + params["enc_pos"]["table"].astype(jnp.bfloat16)
        for i in range(cfg.num_encoder_layers):
            p = jax.tree.map(lambda a, i=i: a[i], params["encoder"])
            h = JL.layernorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = JL._project_qkv(p["mixer"], h, cfg, None, 0.0, with_rope=False)
            ctx = JL.attention_full(q, k, v, causal=False, q_chunk=perf.q_chunk)
            x = x + JL.attn_out(p["mixer"], ctx)
            h = JL.layernorm(p["ln2"], x, cfg.norm_eps)
            x = x + JL.mlp_apply(p["mlp"], h, cfg)
        return JL.layernorm(params["enc_norm"], x, cfg.norm_eps)

    def encode(params, frames, shd=None):
        out = jax.ShapeDtypeStruct(frames.shape, jnp.float32)
        return jax.pure_callback(lambda p, f: np.asarray(body(p, f), np.float32),
                                 out, params, frames)
    return encode


def _jax_model(jcfg):
    """The reference's EncDec, its encoder unrolled (above)."""
    m = jax_make_model(jcfg)
    m.encode = _unrolled_encode(m)
    return m


class _Jitted:
    """The reference model with its modes jitted (each shape traced once)."""

    def __init__(self, m):
        self.encode = jax.jit(m.encode)
        self.prefill = jax.jit(m.prefill, static_argnums=(2,))
        self.decode_step = jax.jit(m.decode_step)


def test_reference_scan_refuses_an_f32_encoder(setup):
    """Why the tests unroll the reference's encoder: its scan raises on f32
    weights, and the unrolled body runs."""
    jcfg, tcfg, _, jp, _ = setup
    frames = jnp.asarray(_frames(tcfg, np.random.default_rng(1)))
    with pytest.raises(TypeError, match="carry"):
        jax_make_model(jcfg).encode(jp, frames)
    assert _jax_model(jcfg).encode(jp, frames).dtype == jnp.float32


def test_from_jax_carries_every_encdec_leaf(setup):
    """Encoder and decoder unstacked layer by layer, the rest as it is, every
    leaf bit for bit; the spec trees have the same leaves."""
    _, tcfg, np32, _, tp = setup
    m = make_model(tcfg)
    assert isinstance(m, EncDec) and not m.supports_paged()
    assert len(tp["encoder"]) == tcfg.num_encoder_layers == 2
    assert len(tp["decoder"]) == tcfg.num_layers == 2
    specs = m.param_specs()
    for i in range(2):
        for part in ("encoder", "decoder"):
            want = jax.tree.map(lambda a, i=i: a[i], np32[part])
            got = tp[part][i]
            for spec, t in P.tree_zip(specs[part][i], got):
                assert spec.shape == tuple(t.shape)
            for g, w in zip(P.tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g.numpy(), w)
    for k in ("embed", "enc_pos", "dec_pos", "enc_norm", "final_norm"):
        for g, w in zip(P.tree_leaves(tp[k]), jax.tree.leaves(np32[k])):
            np.testing.assert_array_equal(g.numpy(), w)
    assert "bq" not in tp["decoder"][0]["cross"]
    assert set(tp["decoder"][0]["mlp"]) == {"w_in", "b_in", "w_out", "b_out"}


def test_encode_matches_reference(setup):
    jcfg, tcfg, _, jp, tp = setup
    jm, tm = _Jitted(_jax_model(jcfg)), make_model(tcfg)
    frames = _frames(tcfg, np.random.default_rng(1), 2)
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, _t(frames))
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    assert _rel(got, want) < REL


def test_prefill_and_decode_match_reference(setup):
    """A right-padded prefill (logits at each row's last valid token, the
    bf16 self-KV and the cross-KV projected from the encoder), then three
    decode steps reading the cross-KV unchanged."""
    jcfg, tcfg, _, jp, tp = setup
    jm, tm = _Jitted(_jax_model(jcfg)), make_model(tcfg)
    rng = np.random.default_rng(2)
    B, S, max_len = 3, 16, 48
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    true = np.array([16, 11, 5], np.int32)
    frames = _frames(tcfg, rng, B)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                        max_len, true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long(), "frames": _t(frames)}, max_len,
                        true_len=_t(true))
    assert _rel(tl, jl) < REL
    assert len(tc) == tcfg.num_layers
    for i, c in enumerate(tc):
        assert c["self"]["k"].dtype == torch.bfloat16
        assert c["self"]["k"].shape == (B, max_len, tcfg.num_kv_heads, tcfg.head_dim)
        assert c["cross"]["k"].shape == (B, tcfg.encoder_seq, tcfg.num_kv_heads,
                                         tcfg.head_dim)
        for n in ("k", "v"):
            np.testing.assert_allclose(c["self"][n].float().numpy(),
                                       np.asarray(jc["self"][n][i], np.float32),
                                       rtol=1e-2, atol=1e-2)
            assert _rel(c["cross"][n], jc["cross"][n][i]) < REL
    cross = [{n: t.clone() for n, t in c["cross"].items()} for c in tc]
    pos = true.copy()
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tp, _t(nxt).long(), _t(pos).long(), tc)
        assert _rel(tl, jl) < REL
        pos = pos + 1
    for c, before in zip(tc, cross):
        for n, t in before.items():
            assert torch.equal(c["cross"][n], t)


# ---------------------------------------------------------------- engine
ENGINE_KW = dict(capacity=2, max_len=22, buckets=(8, 16))   # max_len < encoder_seq
PROMPTS = (6, 12, 3, 16, 9, 20)     # the 20-token prompt is past the largest bucket
MOVED = 1


def _run(eng, make_req, make_sp, settle, move):
    """Greedy serving on a logical clock, every request but the third with
    seeded frames; ``move``: once request ``MOVED`` has 2 tokens, extract
    its row and adopt it back.  Returns (tokens by rid, which submits were
    accepted, the migration payload, the engine)."""
    rng = np.random.default_rng(5)
    accepted = []
    for i, n in enumerate(PROMPTS):
        req = make_req(rid=i, prompt=[int(x) for x in rng.integers(0, eng.cfg.vocab_size, n)],
                       sampling=make_sp(max_new_tokens=5))
        if i != 2:
            req.extras["frames"] = _frames(eng.cfg, rng)
        accepted.append(eng.submit(req, now=0.0))
    payload = None
    t = 0.0
    while eng.pending() and t < 200:
        eng.step(now=t)
        settle(eng)
        live = {q.rid: q for q in eng.row_req.values()}
        if move and payload is None and MOVED in live and len(live[MOVED].output) >= 2:
            req, payload = eng.extract_row(MOVED, now=t)
            assert eng.adopt(req, payload, now=t)
            settle(eng)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}, accepted, payload, eng


@pytest.fixture(scope="module")
def served(setup):
    """The reference engine and two port engines over the same requests; the
    reference's and one port run move request ``MOVED``'s row out and back
    in."""
    jcfg, tcfg, _, jp, tp = setup
    jeng = JEngine(jcfg, params=jp, **ENGINE_KW)
    jeng.model.encode = _unrolled_encode(jeng.model)
    ref = _run(jeng, JRequest, JSamplingParams, lambda e: jax.block_until_ready(e.caches),
               move=True)

    def port(move):
        eng = InferenceEngine(tcfg, params=tp, kv_backend="paged", device="cpu",
                              **ENGINE_KW)
        return _run(eng, Request, SamplingParams, lambda e: None, move)

    return ref, port(False), port(True)


def test_engine_greedy_matches_reference(served):
    """Dense serving (the engine keeps it for an encoder-decoder even when
    asked for the paged backend), frames through ``InferenceEngine.submit``:
    identical greedy tokens; the prompt past the largest bucket bounces
    in both, as enc-dec prompts are never chunked."""
    (want, jacc, _, _), (got, acc, _, eng), _ = served
    assert not eng.paged and not eng._can_chunk
    assert acc == jacc == [True] * 5 + [False]
    assert eng.rejected_long == 1
    assert len(got) == 5 and all(len(v) == 5 for v in got.values())
    assert got == want
    assert not any(st.chunk_rows for st in eng.history)


def test_whisper_row_migration_matches_reference(served):
    """extract_row/adopt of a decoding enc-dec row: the payload carries each
    layer's self-KV and its cross-KV of ``encoder_seq`` slots (longer than
    ``max_len`` here) leaf for leaf as the reference's does, and the adopted
    row decodes the tokens of the run that did not move it."""
    (want, _, jpay, _), (plain, _, _, eng), (moved, _, pay, _) = served
    cfg = eng.cfg
    assert pay is not None and pay["kind"] == "dense"
    assert moved == plain == want
    assert pay["pos"] == jpay["pos"]
    assert not eng.can_convert(eng)
    assert len(pay["caches"]) == cfg.num_layers and cfg.encoder_seq > eng.max_len
    for i, layer in enumerate(pay["caches"]):
        assert layer["self"]["k"].shape[1] == eng.max_len
        assert layer["cross"]["k"].shape == (1, cfg.encoder_seq, cfg.num_kv_heads,
                                             cfg.head_dim)
        for part in ("self", "cross"):
            for n, t in layer[part].items():
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(jpay["caches"][part][n][i], np.float32),
                    rtol=1e-2, atol=1e-2)


def test_serve_launcher_serves_whisper_on_the_cpu():
    """The launcher serves the ``-smoke`` config; its requests carry no
    frames (zeros), as the engine allows."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "whisper-small",
         "--requests", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 4/4 requests" in out.stdout
    assert "model whisper-small: state=ready" in out.stdout
