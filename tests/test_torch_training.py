"""The PyTorch port's training path against the JAX reference, on the CPU.

The data stream, AdamW, the chunked cross-entropy, ``LM.loss`` and
``EncDec.loss`` with their gradients, the train step (8-step loss
trajectories, gradient accumulation), the remat modes, and the kernel
wrappers' refusal of autograd.

Weights are the reference's seeded init in f32, carried across by
``from_jax``, with noise on the norm scales and biases, and with the
attention and SSD projections rescaled to the contracted fan-in (the port's
own init rule, ``params.init``).  Both packages get the same weights.  With
the reference's fan-in (the head count) the scores of random weights are
large and their softmax nearly one-hot: the f32 gradient is then
ill-conditioned, and the reference's own gradient stands further than the
bar from an f64 gradient of the same loss
(``test_reference_init_gradient_is_ill_conditioned``).  Rescaled, the
two agree to about 2e-6.
Losses are held to 1e-5 relative, each gradient leaf to 1e-4 of its
largest magnitude.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.training import optimizer as JO
from repro.training.data import BigramStream as JBigramStream
from repro.training.data import DataConfig as JDataConfig
from repro.training.steps import make_decode_step as jax_make_decode_step
from repro.training.steps import make_prefill_step as jax_make_prefill_step
from repro.training.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.training import optimizer as O
from repro_torch.training.data import BigramStream, DataConfig
from repro_torch.training.steps import (loss_and_grads, make_decode_step,
                                       make_prefill_step, make_train_step)

LOSS_REL = 1e-5
GRAD_REL = 1e-4
TRAJ_REL = 1e-4
MIN_GAP = 1e-5          # between consecutive sorted router probabilities
XENT_CHUNK = 16         # the loss tests' S - 1 = 39 is no multiple of it
# the projections whose reference fan-in is the dim before their last
# (heads or groups) where the contracted size is the one before that
CONTRACTED_IN = ("wq", "wk", "wv", "w_z", "w_x", "w_B", "w_C")


def _rescaled_f32(path, a, noise):
    """A reference leaf in f32 at the port's fan-in, norms and biases noised."""
    keys = [k.key for k in path]
    a = a.astype(np.float32)
    if keys[-1] in CONTRACTED_IN:          # (.., D, n, m): drawn at 1/sqrt(n)
        a = a * np.float32(math.sqrt(a.shape[-2] / a.shape[-3]))
    elif keys[-1] == "wo" or (keys[-1] == "w_out" and "mixer" in keys):
        a = a / np.float32(math.sqrt(a.shape[-3]))   # (.., n, m, D): 1/sqrt(m)
    if keys[-1] in ("scale", "bias", "bq", "bk", "bv", "b_in", "b_out"):
        a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
    return a


@functools.cache
def _setup(arch: str):
    """(reference cfg, port cfg, the reference's f32 weights as numpy) of a
    ``-smoke`` arch, built once a module."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    specs = jax_make_model(jcfg).param_specs()
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(k, specs))(jax.random.PRNGKey(0)))
    noise = np.random.default_rng(4)
    np32 = jax.tree_util.tree_map_with_path(lambda p, a: _rescaled_f32(p, a, noise), raw)
    return jcfg, tcfg, np32


def _weights(arch: str):
    """Fresh copies: (reference cfg, port cfg, jax weights, port weights)."""
    jcfg, tcfg, np32 = _setup(arch)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np32), P.from_jax(np32, tcfg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tbatch(batch: dict) -> dict:
    return {k: _t(v).long() if np.issubdtype(v.dtype, np.integer) else _t(v)
            for k, v in batch.items()}


def _batch(cfg, rng, B=2, S=40) -> dict:
    """Tokens and labels (the second row's last 10 labels ignored), and a
    vlm's patches or an encoder-decoder's frames."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[1, S - 10:] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.num_vision_tokens:
        out["patches"] = rng.normal(0, 0.02, (B, cfg.num_vision_tokens,
                                              cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(0, 0.02, (B, cfg.encoder_seq,
                                             cfg.d_model)).astype(np.float32)
    return out


def _leaf_errors(got_tree, want_np_tree, cfg) -> dict:
    """max |got - want| / max |want| of every leaf, the reference's gradient
    tree unstacked into the port's by ``from_jax``; keyed by leaf path."""
    want = P.from_jax(want_np_tree, cfg)
    out = {}

    def walk(g, w, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], f"{path}/{k}" if path else k)
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        elif g.numel():
            out[path] = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
    walk(got_tree, want, "")
    return out


def _assert_topk_margin(probs, K):
    """Consecutive sorted router probabilities, down to the first one past
    the top-K, differ by at least MIN_GAP."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=-1)[..., : K + 1]
    assert np.diff(-s, axis=-1).min() >= MIN_GAP


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "paligemma-3b-smoke",
                                  "whisper-small-smoke"])
def test_bigram_stream_batches_are_bit_identical(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    dcfg = dict(batch=3, seq_len=24, seed=5)
    ref = JBigramStream(jcfg, JDataConfig(**dcfg))
    port = BigramStream(tcfg, DataConfig(**dcfg), device="cpu")
    assert port.uniform_nll() == ref.uniform_nll()
    for step in (0, 7):
        want, got = ref.batch(step), port.batch(step)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert g.device.type == "cpu"
            if k in ("tokens", "labels"):
                assert g.dtype == torch.int64
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              np.asarray(w).view(np.uint32))


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype):
    """Four AdamW steps on a random tree: warmup, a clipped step (global
    norm far above the clip) and unclipped ones.  f32 parameters within
    1e-6 of their largest magnitude, bf16 within one ulp; the moments, the
    step, the gradient norm and the learning rate too."""
    rng = np.random.default_rng(3)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 2, 4)}}
    cfg = dict(lr=1e-2, warmup_steps=3, grad_clip=1.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s), jdt), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    tparams = P.tree_map(lambda a: _t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)),
                         jax.tree.map(lambda x: x, jparams))
    jstate = {"mu": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams),
              "nu": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"mu": P.tree_map(lambda t: torch.zeros(t.shape), tparams),
              "nu": P.tree_map(lambda t: torch.zeros(t.shape), tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    for i, gscale in enumerate((3.0, 0.01, 0.02, 0.05)):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * gscale,
                             jparams)
        jparams, jstate, jstats = JO.apply_updates(
            jparams, jax.tree.map(lambda g: jnp.asarray(g, jdt), grads), jstate,
            JO.AdamWConfig(**cfg))
        tgrads = P.tree_map(lambda g: _t(np.asarray(jnp.asarray(g, jdt).astype(jnp.float32)))
                            .to(getattr(torch, dtype)), grads)
        tparams, tstate, tstats = O.apply_updates(tparams, tgrads, tstate,
                                                  O.AdamWConfig(**cfg))
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert tstate["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]), rtol=1e-6)
        for got, want in zip(P.tree_leaves(tparams), jax.tree.leaves(jparams)):
            assert got.dtype == getattr(torch, dtype)
            if dtype == "float32":
                w = np.asarray(want)
                assert np.abs(got.numpy() - w).max() <= 1e-6 * np.abs(w).max()
            else:
                gb = got.view(torch.int16).numpy().astype(np.int32)
                wb = np.asarray(want).view(np.int16).astype(np.int32)
                assert np.abs(gb - wb).max() <= 1
        for part in ("mu", "nu"):
            for got, want in zip(P.tree_leaves(tstate[part]), jax.tree.leaves(jstate[part])):
                w = np.asarray(want)
                assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_lr_warmup_and_opt_state_specs():
    cfg = O.AdamWConfig(lr=1.0, warmup_steps=4)
    got = [float(O.lr_at(cfg, torch.tensor(s, dtype=torch.int32))) for s in range(6)]
    assert got == [0.25, 0.5, 0.75, 1.0, 1.0, 1.0]
    specs = make_model(get_config("qwen2-0.5b-smoke")).param_specs()
    state = O.init_opt_state(specs, "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for spec, mu, nu in P.tree_zip(specs, state["mu"], state["nu"]):
        assert mu.shape == nu.shape == spec.shape
        assert mu.dtype == nu.dtype == torch.float32 and not mu.any()


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "qwen3-moe-30b-a3b-smoke"])
def test_chunked_xent_matches_reference(arch):
    """Tied (qwen2) and untied (qwen3-moe) tables; S = 37 over chunks of
    16, ignored labels; the sum, the count and the gradients of x and the
    table."""
    jcfg, tcfg, jp, tp = _weights(arch)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 37, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 37)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, 30:] = -1

    def jfn(p, x):
        nll, cnt = JL.chunked_xent(p, x, jnp.asarray(labels), jcfg, chunk=XENT_CHUNK)
        return nll, cnt
    (jnll, jcnt), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jp["embed"], jnp.asarray(x))
    temb = P.tree_map(lambda t: t.detach().requires_grad_(), tp["embed"])
    tx = _t(x).requires_grad_()
    tnll, tcnt = L.chunked_xent(temb, tx, _t(labels).long(), tcfg, chunk=XENT_CHUNK)
    assert int(tcnt) == int(jcnt) == int((labels >= 0).sum())
    assert abs(float(tnll.detach()) - float(jnll)) <= LOSS_REL * abs(float(jnll))
    tgrads = torch.autograd.grad(tnll, [tx] + P.tree_leaves(temb), materialize_grads=True)
    jg = [np.asarray(jgrads[1])] + [np.asarray(jgrads[0][k]) for k in temb]
    for got, want in zip(tgrads, jg):
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max()


def test_reference_init_gradient_is_ill_conditioned(monkeypatch):
    """Why the loss tests rescale the reference's weights: at its own init
    (fan-in = the head count) the reference's f32 gradient on
    ``qwen2-0.5b-smoke`` stands further than the 1e-4 bar from the gradient
    of the same loss in f64 (the port with its f32 casts made f64), and the
    port's f32 gradient stands nearer to it.  Prints both errors."""
    arch = "qwen2-0.5b-smoke"
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    specs = jax_make_model(jcfg).param_specs()
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(k, specs))(jax.random.PRNGKey(0)))
    noise = np.random.default_rng(4)

    def f32(path, a):
        a = a.astype(np.float32)
        if path[-1].key in ("scale", "bq", "bk", "bv"):
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a
    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    batch = _batch(tcfg, np.random.default_rng(1))
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, xent_chunk=XENT_CHUNK))
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)), has_aux=True))(
        jax.tree.map(jnp.asarray, np32))
    tm = make_model(tcfg, with_overrides(BASELINE, xent_chunk=XENT_CHUNK))
    tp = P.from_jax(np32, tcfg)
    _, _, g32 = loss_and_grads(tm, tp, _tbatch(batch))
    monkeypatch.setattr(L, "f32", torch.float64)
    tb = {k: v.double() if v.is_floating_point() else v for k, v in _tbatch(batch).items()}
    _, _, g64 = loss_and_grads(tm, P.tree_map(lambda t: t.double(), tp), tb)
    ref64 = P.tree_map(lambda t: t.float().numpy(), g64)

    def worst(got):
        return max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in P.tree_zip(got, ref64) if b.size)
    ref_err = worst(P.tree_map(lambda t: t.numpy(),
                               P.from_jax(jax.tree.map(np.asarray, jgrads), tcfg)))
    port_err = worst(P.tree_map(lambda t: t.numpy(), g32))
    print(f"f32 gradients against f64 at the reference's init: reference "
          f"{ref_err:.2e}, port {port_err:.2e}")
    assert ref_err > GRAD_REL and port_err < ref_err


LOSS_ARCHS = ["qwen2-0.5b-smoke", "mamba2-780m-smoke", "qwen3-moe-30b-a3b-smoke",
              "gemma3-27b-smoke", "paligemma-3b-smoke"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, monkeypatch):
    """``LM.loss`` and every gradient leaf against ``jax.value_and_grad`` of
    the reference's: B=2, S=40 (past gemma3-smoke's window of 32, no
    multiple of mamba2-smoke's scan chunk of 32 nor of the xent chunk),
    ignored labels; qwen3-moe with its aux loss, every router input first
    checked for near-ties; paligemma with the prefix shift."""
    jcfg, tcfg, jp, tp = _weights(arch)
    batch = _batch(tcfg, np.random.default_rng(1))
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, xent_chunk=XENT_CHUNK))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)), has_aux=True))(jp)

    routed = []
    route = L.moe_route

    def recording_route(p, x, cfg):
        out = route(p, x, cfg)
        routed.append(out[2].detach().numpy())
        return out
    monkeypatch.setattr(L, "moe_route", recording_route)
    tm = make_model(tcfg, with_overrides(BASELINE, xent_chunk=XENT_CHUNK))
    tloss, tmet, tgrads = loss_and_grads(tm, tp, _tbatch(batch))

    if tcfg.num_experts:
        # each MoE layer routes in the forward pass and again in remat's
        assert len(routed) >= sum(tcfg.layer_is_moe(i) for i in range(tcfg.num_layers))
        for probs in routed:
            _assert_topk_margin(probs, tcfg.experts_per_token)
        assert float(tmet["aux"]) > 0
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    for k in ("nll", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_REL * max(abs(float(jmet[k])), 1)
    errs = _leaf_errors(tgrads, jax.tree.map(np.asarray, jgrads), tcfg)
    assert len(errs) == sum(t.numel() > 0 for t in P.tree_leaves(tp))
    assert max(errs.values()) <= GRAD_REL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


def _reference_encdec_loss(jm, perf):
    """The reference's ``EncDec.loss`` built from its own functions, the
    encoder's ``lax.scan`` unrolled: under f32 weights the scan refuses its
    own carry (bf16 frames in, f32 out of the first layer; ROADMAP §3), so
    the reference's ``loss`` cannot run at f32.  Run un-jitted, op by op,
    as ``tests/test_torch_whisper.py`` runs the encoder."""
    cfg = jm.cfg

    def loss(params, b):
        x = b["frames"].astype(jnp.bfloat16) + params["enc_pos"]["table"].astype(jnp.bfloat16)
        for i in range(cfg.num_encoder_layers):
            p = jax.tree.map(lambda a, i=i: a[i], params["encoder"])
            h = JL.layernorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = JL._project_qkv(p["mixer"], h, cfg, None, 0.0, with_rope=False)
            ctx = JL.attention_full(q, k, v, causal=False, q_chunk=perf.q_chunk)
            x = x + JL.attn_out(p["mixer"], ctx)
            x = x + JL.mlp_apply(p["mlp"], JL.layernorm(p["ln2"], x, cfg.norm_eps), cfg)
        enc = JL.layernorm(params["enc_norm"], x, cfg.norm_eps)
        S = b["tokens"].shape[1]
        x = jm._dec_embed(params, b["tokens"], jnp.arange(S, dtype=jnp.int32))
        x, _ = jm._decoder(params, x, enc, mode="train", caches=None, pos=None,
                           shd=JL._noop_shd, max_len=0)
        x = JL.layernorm(params["final_norm"], x, cfg.norm_eps)
        nll, cnt = JL.chunked_xent(params["embed"], x[:, :-1], b["labels"][:, 1:], cfg,
                                   chunk=perf.xent_chunk)
        return nll / jnp.maximum(cnt.astype(jnp.float32), 1.0), {"nll": nll, "tokens": cnt}
    return loss


# leaves whose gradient reaches them only through the reference's bf16
# roundings (the frames' and positions' sum, the first encoder norm's bf16
# output): their gradients are bf16 values, held to one bf16 ulp of the
# leaf's largest magnitude
BF16_GRAD_LEAVES = ("enc_pos/table", "encoder/0/ln1/scale", "encoder/0/ln1/bias")


def test_encdec_loss_and_grads_match_reference():
    jcfg, tcfg, jp, tp = _weights("whisper-small-smoke")
    perf = dataclasses.replace(JBASELINE, xent_chunk=XENT_CHUNK)
    batch = _batch(tcfg, np.random.default_rng(1))
    (jloss, jmet), jgrads = jax.value_and_grad(
        _reference_encdec_loss(jax_make_model(jcfg, perf), perf), has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    tm = make_model(tcfg, with_overrides(BASELINE, xent_chunk=XENT_CHUNK))
    tloss, tmet, tgrads = loss_and_grads(tm, tp, _tbatch(batch))
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert int(tmet["tokens"]) == int(jmet["tokens"]) and float(tmet["aux"]) == 0
    errs = _leaf_errors(tgrads, jax.tree.map(np.asarray, jgrads), tcfg)
    assert len(errs) == len(P.tree_leaves(tp))
    for path, err in errs.items():
        assert err <= (2.0 ** -7 if path in BF16_GRAD_LEAVES else GRAD_REL), (path, err)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("micro", [(1, "bfloat16"), (2, "float32")],
                         ids=["whole", "microbatch2_f32"])
def test_train_step_trajectory_matches_reference(micro):
    """8 steps of ``train_step`` on qwen2-smoke from the same weights and
    the same ``BigramStream`` batches (B=4, S=24): losses within 1e-4, and
    with two micro-batches accumulated in f32 the reference's microbatched
    step."""
    n, adt = micro
    jcfg, tcfg, jp, tp = _weights("qwen2-0.5b-smoke")
    opt = dict(lr=3e-3, warmup_steps=2)
    jperf = dataclasses.replace(JBASELINE, microbatch=n, accum_dtype=adt)
    _, jstep = jax_make_train_step(jcfg, jperf, JO.AdamWConfig(**opt))
    jstep = jax.jit(jstep)
    _, tstep = make_train_step(tcfg, with_overrides(BASELINE, microbatch=n, accum_dtype=adt),
                               O.AdamWConfig(**opt))
    jstate = {"mu": jax.tree.map(jnp.zeros_like, jp), "nu": jax.tree.map(jnp.zeros_like, jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = O.init_opt_state(make_model(tcfg).param_specs(), "cpu")
    dcfg = dict(batch=4, seq_len=24)
    jdata = JBigramStream(jcfg, JDataConfig(**dcfg))
    tdata = BigramStream(tcfg, DataConfig(**dcfg), device="cpu")
    jl, tl = [], []
    for step in range(8):
        jp, jstate, jmet = jstep(jp, jstate, jdata.batch(step))
        tp, tstate, tmet = tstep(tp, tstate, tdata.batch(step))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert int(tmet["tokens"]) == int(jmet["tokens"])
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    assert tl[-1] < tl[0]
    assert not any(t.requires_grad for t in P.tree_leaves(tp))


def test_prefill_and_decode_steps_match_reference():
    """``make_prefill_step`` / ``make_decode_step``: the argmax of the logits
    (the reference's next tokens), the logits within 1e-4, f32 KV."""
    jcfg, tcfg, jp, tp = _weights("qwen2-0.5b-smoke")
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jperf = dataclasses.replace(JBASELINE, kv_dtype="float32")
    tperf = with_overrides(BASELINE, kv_dtype="float32")
    _, jpre = jax_make_prefill_step(jcfg, 16, jperf)
    _, jdec = jax_make_decode_step(jcfg, jperf)
    _, tpre = make_prefill_step(tcfg, 16, tperf)
    _, tdec = make_decode_step(tcfg, tperf)
    jn, jl, jc = jax.jit(jpre)(jp, {"tokens": jnp.asarray(toks)})
    tn, tl, tc = tpre(tp, {"tokens": _t(toks).long()})
    pos = np.full((2,), 12, np.int32)
    for _ in range(2):
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(jl)).max()))
        jn, jl, jc = jax.jit(jdec)(jp, jn[:, None], jnp.asarray(pos), jc)
        tn, tl, tc = tdec(tp, tn[:, None], _t(pos).long(), tc)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b-smoke", "qwen3-moe-30b-a3b-smoke",
                                  "mamba2-780m-smoke", "whisper-small-smoke"])
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """``remat`` none, full and dots: recomputation changes no number."""
    _, tcfg, _, tp = _weights(arch)
    batch = _tbatch(_batch(tcfg, np.random.default_rng(7)))
    out = {}
    for mode in ("none", "full", "dots"):
        m = make_model(tcfg, with_overrides(BASELINE, remat=mode, xent_chunk=XENT_CHUNK))
        out[mode] = loss_and_grads(m, tp, batch)
    loss0, _, g0 = out["none"]
    for mode in ("full", "dots"):
        loss, _, g = out[mode]
        assert float(loss) == float(loss0), mode
        for a, b in zip(P.tree_leaves(g), P.tree_leaves(g0)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        make_model(tcfg, with_overrides(BASELINE, remat="some")).loss(tp, batch)


# ------------------------------------------------- autograd and the kernels
def test_plain_attention_autograd_form_matches_serving_form():
    """``_mha_chunk``'s out-of-place form (under autograd) computes the
    in-place form's numbers, and its backward runs (the in-place ``exp_``
    then ``div_`` made ``backward()`` raise)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 12, 4, 16), generator=gen)
    k, v = (torch.randn((2, 12, 2, 16), generator=gen) for _ in range(2))
    with torch.no_grad():
        want = L.attention_full(q, k, v, causal=True, window=5, prefix_len=3, q_chunk=5)
    qg = q.clone().requires_grad_()
    got = L.attention_full(qg, k, v, causal=True, window=5, prefix_len=3, q_chunk=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.square().sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


def test_kernel_wrappers_refuse_autograd():
    """Each kernel wrapper raises under autograd on the CPU too (its CUDA
    kernel has no backward, so the gradient through it would be zero on
    the card), and runs its plain version without grad."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 16), generator=gen)
    k, v = (torch.randn((1, 8, 2, 16), generator=gen) for _ in range(2))
    x = torch.randn((1, 8, 2, 4), generator=gen)
    B, C = (torch.randn((1, 8, 1, 4), generator=gen) for _ in range(2))
    dt = torch.rand((1, 8, 2), generator=gen)
    pools = [torch.randn((4, 4, 2, 16), generator=gen) for _ in range(2)]
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    ctx = torch.tensor([6], dtype=torch.int32)
    calls = {
        "attention": lambda g: flash_attention(q.requires_grad_(g), k, v),
        "ssd_scan": lambda g: ssd_scan(x.requires_grad_(g), B, C, dt, -dt, chunk=4),
        "paged_decode_attention": lambda g: paged_decode_attention(
            q[:, 0].detach().requires_grad_(g), *pools, table, ctx),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)
    # the fault this guards against: a prefill through the kernels with
    # weights that record autograd
    cfg = get_config("qwen2-0.5b-smoke")
    m = make_model(cfg)
    params = P.tree_map(lambda t: t.float().requires_grad_(),
                        P.init(torch.Generator().manual_seed(0), m.param_specs(), "cpu"))
    with pytest.raises(RuntimeError, match="attention has no backward"):
        m.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, 16)
