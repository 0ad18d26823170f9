"""The PyTorch port's model against the JAX reference, on the CPU.

Same f32 weights (the reference's seeded init through ``from_jax``), same
numpy inputs.  Layers, then every serving mode of the LM, on
``qwen2-0.5b-smoke`` (4 heads over 1 kv head) and on a rep-7 variant with
qwen2's head layout (14 heads over 2 kv heads), with the kernel ops on
(their plain versions on the CPU) and off.  Logits within rel 1e-4, with
f32 KV caches on both sides: a bf16 cache can round one entry differently
after an f32 difference in the last bit, which the engine tests cover with
token identity instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.models import layers as JL
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE, with_overrides
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.lm import make_model

ARCHS = ["smoke", "rep7"]
REL = 1e-4


def _cfgs(arch):
    jcfg, tcfg = jax_get_config("qwen2-0.5b-smoke"), get_config("qwen2-0.5b-smoke")
    if arch == "rep7":
        kw = dict(num_heads=14, num_kv_heads=2, head_dim=16, d_model=112)
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    specs = jm.param_specs()
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(k, specs))(jax.random.PRNGKey(0)))
    noise = np.random.default_rng(4)

    def f32(path, a):
        a = a.astype(np.float32)
        if path[-1].key in ("bq", "bk", "bv", "scale"):
            # nonzero biases and norm scales, so the test sees them
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a

    np32 = jax.tree_util.tree_map_with_path(f32, raw)
    jparams = jax.tree.map(jnp.asarray, np32)
    tparams = P.from_jax(np32, tcfg)
    return jcfg, tcfg, jm, raw, jparams, tparams


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ parameters
def test_from_jax_round_trips_every_leaf(setup):
    """bf16 and f32 leaves arrive bit-identical, unstacked per layer."""
    jcfg, tcfg, _, raw, _, _ = setup
    tree = raw
    params = P.from_jax(tree, tcfg)
    assert len(params["layers"]) == tcfg.num_layers

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def tbits(t):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())

    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(tcfg.num_layers):
                t = params["layers"][i]
                for k in keys[2:]:
                    t = t[k]
                assert str(t.dtype).endswith(str(leaf.dtype)), (keys, t.dtype)
                np.testing.assert_array_equal(tbits(t), bits(leaf[i]))
                n += 1
        else:
            t = params
            for k in keys:
                t = t[k]
            np.testing.assert_array_equal(tbits(t), bits(leaf))
            n += 1
    spec_leaves = P.tree_leaves(make_model(tcfg).param_specs())
    assert n == len(spec_leaves)


# ---------------------------------------------------------------- layers
def test_layers_match_reference(setup):
    jcfg, tcfg, _, _, jp, tp = setup
    rng = np.random.default_rng(1)
    B, S, D = 2, 7, tcfg.d_model
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]], np.int32)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["m0"])
    tl = tp["layers"][0]
    assert _rel(L.rmsnorm(tl["ln1"], _t(x), tcfg.norm_eps),
                JL.rmsnorm(jl["ln1"], x, jcfg.norm_eps)) < REL
    h = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    assert _rel(L.rope(_t(h), _t(pos), 1e6), JL.rope(h, pos, 1e6)) < REL
    tq = L._project_qkv(tl["mixer"], _t(x), tcfg, _t(pos), tcfg.rope_theta)
    jq = JL._project_qkv(jl["mixer"], x, jcfg, pos, jcfg.rope_theta)
    for a, b in zip(tq, jq):
        assert _rel(a, b) < REL
    assert _rel(L.mlp_apply(tl["mlp"], _t(x), tcfg), JL.mlp_apply(jl["mlp"], x, jcfg)) < REL
    lg = L.unembed_logits(tp["embed"], _t(x), tcfg)
    assert lg.dtype == torch.float32
    assert _rel(lg, JL.unembed_logits(jp["embed"], x, jcfg)) < REL


# ------------------------------------------------------------ LM modes
@pytest.mark.parametrize("use_kernels", [True, False])
def test_lm_modes_match_reference(setup, use_kernels):
    """prefill -> decode_step on the dense cache; prefill_chunk twice on a
    pool cache; prefill_chunk_paged twice -> decode_step_paged with a dead
    row.  Logits and the KV each mode leaves behind match the reference."""
    jcfg, tcfg, jm, _, jp, tp = setup
    tm = make_model(tcfg, with_overrides(BASELINE, use_kernels=use_kernels,
                                         kv_dtype="float32"))
    rng = np.random.default_rng(2)
    B, S, max_len, V = 3, 16, 48, tcfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    true = np.array([16, 11, 5], np.int32)

    # bucketed prefill + dense decode
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len,
                        true_len=jnp.asarray(true))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks).long()}, max_len, true_len=_t(true))
    assert tl.dtype == torch.float32 and _rel(tl, jl) < REL
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(true), jc)
    tl, _ = tm.decode_step(tp, _t(nxt).long(), _t(true).long(), tc)
    assert _rel(tl, jl) < REL
    for i in range(tcfg.num_layers):
        assert _rel(tc[i]["k"], jc["blocks"]["m0"]["k"][i]) < REL

    # chunked prefill on a pool cache; row 2 idles in chunk 1
    C = 8
    chunks = [(np.array([0, 0, 0]), np.array([8, 8, 0])),
              (np.array([8, 8, 0]), np.array([8, 3, 5]))]
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JP.init(jax.random.PRNGKey(0), jm.cache_specs(B, max_len)))
    tcache = P.tree_map(lambda t: t.float(),
                        P.init(None, tm.cache_specs(B, max_len), "cpu"))
    for pos0, nval in chunks:
        part = np.stack([toks[b, pos0[b]:pos0[b] + C] if pos0[b] + C <= S
                         else np.zeros(C, np.int32) for b in range(B)])
        jl, jcache = jm.prefill_chunk(jp, jnp.asarray(part), jnp.asarray(pos0, jnp.int32),
                                      jnp.asarray(nval, jnp.int32), jcache)
        tl, tcache = tm.prefill_chunk(tp, _t(part).long(), _t(pos0), _t(nval), tcache)
        assert _rel(tl[nval > 0], np.asarray(jl)[nval > 0]) < REL
    assert _rel(tcache[1]["v"], jcache["blocks"]["m0"]["v"][1]) < REL

    # paged: shuffled blocks, -1 tails, a dead row in decode
    nb, bs, max_blk = 16, 4, 6
    table = np.full((B, max_blk), -1, np.int32)
    perm = np.random.default_rng(3).permutation(nb)
    table[0, :5] = perm[:5]
    table[1, :4] = perm[5:9]
    table[2, :2] = perm[9:11]
    jpools = JP.init(jax.random.PRNGKey(0), jm.paged_cache_specs(nb, bs))
    tpools = P.init(None, tm.paged_cache_specs(nb, bs), "cpu")
    for pos0, nval in chunks:
        part = np.stack([toks[b, pos0[b]:pos0[b] + C] if pos0[b] + C <= S
                         else np.zeros(C, np.int32) for b in range(B)])
        jl, jpools = jm.prefill_chunk_paged(
            jp, jnp.asarray(part), jnp.asarray(pos0, jnp.int32),
            jnp.asarray(nval, jnp.int32), jpools, jnp.asarray(table))
        tl, tpools = tm.prefill_chunk_paged(tp, _t(part).long(), _t(pos0), _t(nval),
                                            tpools, _t(table))
        assert _rel(tl[nval > 0], np.asarray(jl)[nval > 0]) < REL
    pos = np.array([16, 11, 5], np.int32)
    live = np.array([True, True, False])
    nxt = np.asarray(tl).argmax(-1)[:, None].astype(np.int32)
    jl, jpools = jm.decode_step_paged(jp, jnp.asarray(nxt), jnp.asarray(pos), jpools,
                                      jnp.asarray(table), jnp.asarray(live))
    tl, tpools = tm.decode_step_paged(tp, _t(nxt).long(), _t(pos).long(), tpools,
                                      _t(table), _t(live))
    assert _rel(tl, jl) < REL
    for i in range(tcfg.num_layers):
        for n in ("k", "v"):
            ref = np.asarray(jpools["blocks"]["m0"][n][i], np.float32)
            got = tpools[i][n].float().numpy()
            assert _rel(tpools[i][n], ref) < REL
            # blocks no table maps were never written (dropped writes)
            unmapped = np.setdiff1d(np.arange(nb), table[table >= 0])
            assert not got[unmapped].any() and not ref[unmapped].any()


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_unported_families_raise(arch):
    """No family is left unported: every arch of the reference's registry
    builds in the port, its ``-smoke`` config too, and takes the paged
    backend exactly where the reference does (a vision prefix, SSM state,
    ring layers and an encoder keep the dense one)."""
    for name in (arch, arch + "-smoke"):
        m = make_model(get_config(name))
        assert m.param_specs()
        ref = jax_make_model(jax_get_config(name))
        # the reference's EncDec has no supports_paged: it serves dense only
        want = ref.supports_paged() if hasattr(ref, "supports_paged") else False
        assert m.supports_paged() == want
    vlm = dataclasses.replace(get_config("qwen2-0.5b-smoke"), num_vision_tokens=8)
    assert not make_model(vlm).supports_paged()
