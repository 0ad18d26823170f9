"""The port's sharded serving program (``distributed/spmd.py``) against the
unsharded port and the JAX reference, on the CPU.

One ``mp.spawn`` for the whole file starts four ranks over gloo on a
(data 2, model 2) mesh (``tests/torch_sharded_worker.py``; a ``FileStore``
under ``tmp_path``, so parallel test workers never share a port).  Each
rank runs the sharded ``prefill`` and ``decode_step`` of qwen2-0.5b,
qwen3-moe-30b-a3b, mamba2-780m, gemma3-27b, whisper-small, paligemma-3b and
jamba-v0.1-52b (``-smoke``), and of mixtral-8x7b-smoke with three experts
(which do not divide the model axis), at f32 under the ``tp`` rules, on
the reference's init carried over by ``from_jax``.
Gathered by batch rows, the logits hold to the unsharded port's within
1e-5 (jamba, whose conditioning is worse, 1e-4) and to the reference's
step within 1e-4 (relative to the largest logit, as the port's other
parity tests measure); under ``zero3`` and
``dp``, and at one row (the caches' slots over ``data``), they hold to the
unsharded port.  Rank 0 of a prefill and a decode cell of the port's own
widths, run on real CPU tensors, has the peak and the collective bytes of
the dry run's trace of the same cell on ``meta``, to the byte; both run
over the fake process group, whose collectives complete on the calling
thread (gloo's worker threads can hold a collective's input past its
wait, so a free under load comes late and a gloo run's peak is not
exact).  The per-card argument bytes of
two full-width cells are held to the reference's ``Sharder.spec_for`` on
both of its meshes under every rule table, the collective bytes of a
``tp`` decode step to a count by hand, and ``serve --dryrun --mesh single``
exits 0.
"""
import dataclasses
import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_worker as W
from test_torch_whisper import _unrolled_encode
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.perf import BASELINE as JBASELINE
from repro.distributed.sharding import Sharder as JSharder
from repro.distributed.sharding import rules_for as jax_rules_for
from repro.launch import specs as JSP
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed.sharding import Sharder, rules_for
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch.build import build_cell, real_local_args, trace_cell
from repro_torch.models import params as P
from repro_torch.models.lm import make_model

ARCHS = tuple(W.LAYOUTS)
TO_PORT = 1e-5
# jamba-smoke's one-card logits move by 3.3e-5 when every weight is scaled
# by 1 + 1e-7 (its attention layer takes the residual from 23 to 76 on the
# reference's init), so the f32 rounding of a tensor-parallel sum moves
# them that far too (2.8e-5 at prefill): it is held to the reference's bar
TO_PORT_OF = {"jamba-v0.1-52b-smoke": 1e-4}
TO_REFERENCE = 1e-4
COUNT_SHAPES = {"prefill": ShapeConfig("prefill", W.S, W.B, "prefill"),
                "decode": ShapeConfig("decode", W.L, W.B, "decode")}
COUNT_PERF = PerfConfig(use_kernels=False)


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / (np.abs(ref).max() + 1e-9))


def _config(name):
    return W.config(name)


def _jax_config(name):
    return W.config(name, jax_get_config)


def _f32_params(jcfg):
    """The reference's init in f32 with nonzero norm scales and MLP biases
    (whisper's ``b_in``, split with the hidden width, and ``b_out``, added
    once after the reduction) (numpy tree)."""
    raw = JP.init(jax.random.PRNGKey(0), jax_make_model(jcfg).param_specs())
    noise = np.random.default_rng(4)

    def f32(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key in ("scale", "b_in", "b_out"):
            a = a + 0.1 * noise.normal(size=a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f32, raw)


def _inputs(cfg) -> dict:
    """A prompt of ``W.S`` positions (a vlm's patches, then its text;
    an encoder-decoder's frames beside it), then one decode token."""
    rng = np.random.default_rng(7)
    nv = cfg.num_vision_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (W.B, W.S - nv), dtype=np.int32)}
    if nv:
        batch["patches"] = rng.normal(0, 0.5, (W.B, nv, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(0, 0.02, (W.B, cfg.encoder_seq,
                                               cfg.d_model)).astype(np.float32)
    return {"batch": batch,
            "tok": rng.integers(0, cfg.vocab_size, (W.B, 1), dtype=np.int32),
            "pos": np.full((W.B,), W.S, np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results for every arch, after one spawn."""
    out = tmp_path_factory.mktemp("sharded")
    for arch in ARCHS:
        cfg = _config(arch)
        x = _inputs(cfg)
        torch.save({"params": P.from_jax(_f32_params(_jax_config(arch)), cfg),
                    "batch": {k: torch.from_numpy(v) for k, v in x["batch"].items()},
                    "tok": torch.from_numpy(x["tok"]), "pos": torch.from_numpy(x["pos"])},
                   out / f"{arch}.in.pt")
    mp.spawn(W.run, args=(str(out / "store"), str(out), list(ARCHS)), nprocs=W.WORLD)
    return {arch: [torch.load(out / f"{arch}.{r}.pt") for r in range(W.WORLD)]
            for arch in ARCHS}


def _gathered(ranks, key) -> np.ndarray:
    """Every batch row's logits, each from a rank that holds it."""
    out = np.zeros((max(sum(r["rows"]) for r in ranks), ranks[0][key].shape[-1]),
                   np.float32)
    for r in ranks:
        off, n = r["rows"]
        out[off:off + n] = r[key].numpy()
    return out


def _reference(arch) -> dict:
    """The reference's steps; whisper's encoder unrolled, as its own parity
    tests run it (its scan refuses f32 weights)."""
    jcfg = _jax_config(arch)
    jm = jax_make_model(jcfg, dataclasses.replace(JBASELINE, kv_dtype="float32"))
    if jcfg.is_encoder_decoder:
        jm.encode = _unrolled_encode(jm)
    jp = jax.tree.map(jnp.asarray, _f32_params(jcfg))
    x = _inputs(_config(arch))
    logits, caches = jm.prefill(jp, {k: jnp.asarray(v) for k, v in x["batch"].items()},
                                W.L)
    dec, _ = jm.decode_step(jp, jnp.asarray(x["tok"]), jnp.asarray(x["pos"]), caches)
    return {"prefill": np.asarray(logits), "decode": np.asarray(dec)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_match_port_and_reference(runs, arch):
    ranks = runs[arch]
    ref = _reference(arch)
    for key in ("prefill", "decode"):
        got = _gathered(ranks, key)
        assert _rel(got, ranks[0]["one_card"][key]) <= TO_PORT_OF.get(arch, TO_PORT), key
        assert _rel(got, ref[key]) <= TO_REFERENCE, key


@pytest.mark.parametrize("arch,part,rows",
                         [(a, p, n) for a in ARCHS for p, n in W.LAYOUTS[a]])
def test_other_layouts_match_the_port(runs, arch, part, rows):
    """The same steps under the other rule tables (``zero3`` gathers the
    weights it stores over ``data`` at use; ``dp`` keeps them whole) and at
    one row (no batch split: the caches' slots go over ``data``, the
    softmax merges across it): each rank's logits hold to the unsharded
    port's on the same rows."""
    ranks = [r["layouts"][part, rows] for r in runs[arch]]
    assert _gathered(ranks, "prefill").shape[0] == rows
    for r in ranks:
        for key in ("prefill", "decode"):
            assert _rel(r[key], r["own"][key]) <= TO_PORT_OF.get(arch, TO_PORT), \
                (key, r["rows"])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_kind_shards_a_parameter(arch):
    """On the (2, 2) mesh under ``tp`` every layer's mixer (an
    encoder-decoder's self- and cross-attention), and its MLP where it has
    one, holds a parameter split over a mesh axis: the test runs
    tensor-parallel code in every layer kind."""
    m = make_model(_config(arch))
    sh = Sharder(M.LogicalMesh(W.MESH), rules_for("tp"))
    specs = m.param_specs()
    if "layers" in specs:
        parts = [{k: layer[k] for k in ("mixer", "mlp")
                  if k == "mixer" or m.cfg.d_ff or m.moes[i]}
                 for i, layer in enumerate(specs["layers"])]
    else:
        parts = [{k: v for k, v in layer.items() if not k.startswith("ln")}
                 for layer in specs["encoder"] + specs["decoder"]]
    for i, layer in enumerate(parts):
        for part, tree in layer.items():
            assert any(P.tree_leaves(sh.spec_shardings(tree))), (arch, i, part)
    assert sh.spec_shardings(specs["embed"])["embedding"] == ("model",)


def test_the_moe_fallback_layout():
    """mixtral-8x7b-smoke with three experts: they do not divide the model
    axis and stay whole on every device, and the experts' hidden width
    takes the axis, so the MoE's partial sums are reduced over it."""
    m = make_model(_config("mixtral-8x7b-smoke-e3"))
    sh = Sharder(M.LogicalMesh(W.MESH), rules_for("tp"))
    mlp = sh.spec_shardings(m.param_specs()["layers"][1]["mlp"])
    assert m.moes[1] and m.cfg.num_experts == 3
    assert mlp["w_gate"] == mlp["w_up"] == (None, None, "model")
    assert mlp["w_down"] == (None, "model")


def _cpu_counts(arch, kind) -> dict:
    """Rank 0 of a cell of ``COUNT_SHAPES`` run once on real CPU tensors
    under ``cost.OpCounter`` (the collector held off, as the dry run holds
    it): its peak and collective bytes.  The caller opens the fake
    process group."""
    cell = build_cell(_config(arch), COUNT_SHAPES[kind], M.LogicalMesh(W.MESH), COUNT_PERF)
    args = real_local_args(cell, "cpu", torch.Generator().manual_seed(1))
    gc.collect()
    gc.disable()
    try:
        with cost.OpCounter() as c:
            c.track(args)
            cell.fn(*args)
    finally:
        gc.enable()
    return {"peak": c.peak, "collectives": dict(c.collectives)}


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_equals_the_cpu_run(arch, kind):
    """Rank 0's cell traced on ``meta`` (the dry run's way) against the
    same cell run on real CPU tensors at rank 0: the same peak and the same
    collective bytes, to the byte."""
    with M.fake_world(W.WORLD):
        cell = build_cell(_config(arch), COUNT_SHAPES[kind], M.LogicalMesh(W.MESH),
                          COUNT_PERF)
        t = trace_cell(cell)
        cpu = _cpu_counts(arch, kind)
    assert t["memory"]["peak_bytes"] == cpu["peak"]
    assert t["collectives"] == cpu["collectives"]
    assert t["collectives"]["total"] > 0


def _ref_local_bytes(sh: JSharder, shape, axes, dtype) -> int:
    spec = tuple(sh.spec_for(tuple(shape), tuple(axes)))
    n = 1
    for d, size in enumerate(shape):
        p = spec[d] if d < len(spec) else None
        parts = () if p is None else (p if isinstance(p, tuple) else (p,))
        n *= size // math.prod(sh.mesh.shape[a] for a in parts)
    return n * np.dtype(dtype).itemsize


def _ref_argument_bytes(arch, shape_name, mesh_shape, part) -> int:
    """The sum of the local shard sizes of the reference's arguments of a
    cell under its ``Sharder.spec_for`` on ``FakeMesh``."""
    jcfg, shape = jax_get_config(arch), JSHAPES[shape_name]
    jm = jax_make_model(jcfg)
    sh = JSharder(FakeMesh(mesh_shape), jax_rules_for(part))
    leaves = [(s.shape, s.axes, s.dtype)
              for s in jax.tree.leaves(jm.param_specs(), is_leaf=JP.is_spec)]
    B = shape.global_batch
    if shape.kind == "prefill":
        for v in JSP.batch_specs(jcfg, shape, with_labels=False).values():
            names = ("batch", "act_seq") + (None,) * (len(v.shape) - 2)
            leaves.append((v.shape, names[:len(v.shape)], v.dtype))
    else:
        d = JSP.decode_specs(jcfg, shape, jm)
        leaves += [(d["tokens"].shape, ("batch", None), d["tokens"].dtype),
                   (d["pos"].shape, ("batch",), d["pos"].dtype)]
        leaves += [(s.shape, s.axes, s.dtype) for s in
                   jax.tree.leaves(d["cache_param_specs"], is_leaf=JP.is_spec)]
        assert d["tokens"].shape == (B, 1)
    return sum(_ref_local_bytes(sh, *leaf) for leaf in leaves)


@pytest.mark.parametrize("part", ("tp", "zero3", "dp"))
@pytest.mark.parametrize("mesh_name", ("16x16", "2x16x16"))
@pytest.mark.parametrize("arch,shape", (("qwen3-moe-30b-a3b", "decode_32k"),
                                        ("gemma3-27b", "prefill_32k")))
def test_argument_bytes_per_card_match_reference(arch, shape, mesh_name, part):
    mesh = M.LogicalMesh(dict(M.POD_MESHES[mesh_name]))
    perf = dataclasses.replace(BASELINE, partitioning=part)
    with M.fake_world(mesh.size):
        cell = build_cell(get_config(arch), SHAPES[shape], mesh, perf)
        got = sum(t.numel() * t.element_size()
                  for t in P.tree_leaves(list(cell.local_args())))
    assert got == _ref_argument_bytes(arch, shape, mesh.shape, part)


def test_collective_bytes_of_a_tp_decode_step_by_hand():
    """qwen2-0.5b-smoke's decode step at rank 0 of the (data 2, model 2)
    mesh: 4 rows over data (2 a rank), 4 query heads over model (2 a rank),
    its one KV head whole, the cache's 48 slots over model (24 a rank), the
    MLP's 128 and the vocabulary's 512 over model.  Every collective runs
    over the model axis (g = 2)."""
    cfg = get_config("qwen2-0.5b-smoke")
    b, D, H, hd, V = W.B // 2, cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    bf16, f32 = 2, 4
    g = 2
    # the embedding: each rank looks up its half of the vocabulary -> one
    # all-reduce of the (b, 1, D) bf16 activations
    reduce = [b * D * bf16]
    gather = []
    for _ in range(cfg.num_layers):
        # the query heads are split over model, and so are the cache's slots:
        # the queries are gathered whole, (b, 1, H, hd) bf16
        gather.append(b * H * hd * bf16)
        # the softmax across the slots: the max and the sum of the
        # exponentials, (b, KV, rep, 1) f32 each, then the weighted values
        # (b, KV, rep, hd) bf16
        reduce += [b * H * f32, b * H * f32, b * H * hd * bf16]
        # the output projection and the MLP's down projection: row-parallel,
        # (b, 1, D) bf16 each
        reduce += [b * D * bf16, b * D * bf16]
    # the logits: (b, 1, V) f32, gathered whole over the vocabulary
    gather.append(b * V * f32)
    want = {"all-reduce": sum(2 * x * (g - 1) / g for x in reduce),
            "all-reduce_payload": sum(reduce),
            "all-gather": sum(x * (g - 1) / g for x in gather),
            "all-gather_payload": sum(gather),
            "count": len(reduce) + len(gather)}
    want["total"] = want["all-reduce"] + want["all-gather"]
    with M.fake_world(W.WORLD):
        assert _cpu_counts("qwen2-0.5b-smoke", "decode")["collectives"] == want


def test_serve_dryrun_on_the_pod_mesh(capsys):
    assert serve_launcher.main(["--arch", "qwen2-0.5b", "--dryrun", "--mesh", "single"]) == 0
    printed = capsys.readouterr().out
    assert "[16x16] qwen2-0.5b x decode_32k: OK" in printed and "0 failures" in printed
