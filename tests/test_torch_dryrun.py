"""The port's production dry run against the JAX reference, on the CPU.

The sharding rules, the shape registry, the micro-batch default and the
meta-device input specs are held to the reference's (``repro.distributed``,
``repro.configs``, ``repro.launch``) over every arch's full-width specs.
The op counter (``launch/cost.py``) is held to exact counts: a matmul's
flops and bytes, and a smoke step's peak on ``meta`` against the same
step's peak on real CPU tensors.  The kernel wrappers' meta branches
return the kernels' shapes and report their analytic work.  Full-width
cells are traced on ``meta``: qwen2-0.5b fits one H100 at decode_32k,
jamba-v0.1-52b does not, qwen2-0.5b skips long_500k with the reference's
reason, and the launchers' ``--dryrun`` / ``--production`` exit 0 here,
where there is no GPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import arch_shape_cells as jax_arch_shape_cells
from repro.configs import get_config as jax_get_config
from repro.configs import shape_supported as jax_shape_supported
from repro.configs.base import model_flops_per_token as jax_model_flops
from repro.configs.perf import BASELINE as JBASELINE
from repro.distributed.sharding import Sharder as JSharder
from repro.distributed.sharding import rules_for as jax_rules_for
from repro.launch import specs as JSP
from repro.launch.build import default_perf as jax_default_perf
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro_torch.configs import ARCH_IDS, SHAPES, arch_shape_cells, get_config, shape_supported
from repro_torch.configs.base import model_flops_per_token
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed.sharding import Sharder, opt_sharding_tree, rules_for
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.launch import cost, dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import specs as SP
from repro_torch.launch import train as train_launcher
from repro_torch.launch.build import default_perf
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.training import optimizer as OPT
from repro_torch.training.steps import make_prefill_step, make_train_step

META = torch.device("meta")


class FakeMesh:
    """``tests/test_sharding.py``'s stand-in for a device mesh."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


FAKE_MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


# ------------------------------------------------------------ sharding
def _leaves(specs) -> list[tuple[tuple, tuple]]:
    return [(tuple(s.shape), tuple(s.axes))
            for s in JP.jax.tree.leaves(specs, is_leaf=JP.is_spec)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_matches_reference(arch):
    """Every full-width parameter and decode_32k cache leaf (the reference's
    stacked layout and the port's per-layer one) resolves to the
    reference's spec and ZeRO-1 spec under every rule table on both of the
    reference's meshes; on the one-card mesh every spec is empty."""
    jm = jax_make_model(jax_get_config(arch))
    m = make_model(get_config(arch))
    B, S = JSHAPES["decode_32k"].global_batch, JSHAPES["decode_32k"].seq_len
    pleaves = _leaves(jm.param_specs())
    leaves = (pleaves + _leaves(jm.cache_specs(B, S))
              + [(tuple(s.shape), tuple(s.axes))
                 for s in P.tree_leaves(m.param_specs()) + P.tree_leaves(m.cache_specs(B, S))])
    for shape in FAKE_MESHES:
        for part in ("tp", "zero3", "dp"):
            ref = JSharder(FakeMesh(shape), jax_rules_for(part))
            port = Sharder(M.LogicalMesh(shape), rules_for(part))
            for shp, axes in leaves:
                assert port.spec_for(shp, axes) == tuple(ref.spec_for(shp, axes)), \
                    (part, shape, shp, axes)
            for shp, axes in pleaves:
                s = JP.ParamSpec(shp, axes)
                assert port.zero1_spec(P.ParamSpec(shp, axes)) == tuple(ref.zero1_spec(s))
    one = Sharder(M.make_production_mesh())
    assert all(one.spec_for(shp, axes) == () for shp, axes in leaves)
    specs = m.param_specs()
    assert all(sp == () for sp in P.tree_leaves(one.spec_shardings(specs)))
    opt = opt_sharding_tree(one, specs)
    assert all(sp == () for sp in P.tree_leaves(opt["mu"])) and opt["step"] == ()
    x = torch.zeros(2, 3)
    assert one(x, ("batch", "embed")) is x and Sharder(None)(x, ("batch",)) is x


def test_the_one_card_mesh():
    """The hook is the identity on one card; on a mesh of several devices it
    redistributes a DTensor to the placements of its spec (the rows cut
    over ``data``) and refuses a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    prod = M.make_production_mesh()
    assert prod.shape == {"data": 1, "model": 1} and prod.size == 1
    assert M.make_debug_mesh(4, 2).axis_names == ("data", "model")
    x = torch.zeros(2)
    assert Sharder(prod)(x, ("batch",)) is x
    mesh = M.make_debug_mesh(2, 1)
    with M.fake_world(mesh.size):
        whole = DTensor.from_local(torch.arange(4.0), M.device_mesh(mesh),
                                   [Replicate(), Replicate()], run_check=False)
        out = Sharder(mesh)(whole, ("batch",))
        assert tuple(out.placements) == (Shard(0), Replicate())
        assert out.to_local().tolist() == [0.0, 1.0] and tuple(out.shape) == (4,)
        with pytest.raises(TypeError):
            Sharder(mesh)(x, ("batch",))


# ------------------------------------------------------------ configs
def test_shapes_cells_and_microbatches_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert sorted(arch_shape_cells(include_skipped=True)) == \
        sorted(jax_arch_shape_cells(include_skipped=True))
    assert len(list(arch_shape_cells(include_skipped=True))) == 40
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert model_flops_per_token(cfg, 123_456) == jax_model_flops(jcfg, 123_456)
        for name, shape in SHAPES.items():
            assert shape_supported(cfg, shape) == jax_shape_supported(jcfg, JSHAPES[name])
            jshape = JSHAPES[name]
            # the reference fixes data = 16; at data = 1 its formula is the
            # one of a 16x wider model
            wide = dataclasses.replace(jcfg, d_model=jcfg.d_model * 16)
            for data, ref in ((16, jax_default_perf(jcfg, jshape, JBASELINE)),
                              (1, jax_default_perf(wide, jshape, JBASELINE))):
                got = default_perf(cfg, shape, BASELINE, data=data)
                assert got.microbatch == ref.microbatch, (arch, name, data)
    assert default_perf(get_config("qwen2-0.5b"), SHAPES["train_4k"]).microbatch == 16
    assert default_perf(get_config("gemma3-27b"), SHAPES["train_4k"]).microbatch == 128


def _sds(t) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Batch specs equal the reference's ShapeDtypeStructs; decode caches
    hold the reference's bytes at every supported decode cell."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind != "decode":
            for labels in (False, True):
                got = SP.batch_specs(cfg, shape, with_labels=labels)
                ref = JSP.batch_specs(jcfg, JSHAPES[name], with_labels=labels)
                assert {k: _sds(v) for k, v in got.items()} == \
                    {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
                assert all(v.device == META for v in got.values())
        elif shape_supported(cfg, shape)[0]:
            got = SP.decode_specs(cfg, shape)
            ref = JSP.decode_specs(jcfg, JSHAPES[name])
            assert sum(t.nbytes for t in P.tree_leaves(got["caches"])) == \
                sum(s.size * s.dtype.itemsize
                    for s in JP.jax.tree.leaves(ref["caches"]))
            assert _sds(got["tokens"]) == (tuple(ref["tokens"].shape), "int32")
            assert _sds(got["pos"]) == (tuple(ref["pos"].shape), "int32")
        ins = SP.input_specs(cfg, shape)
        assert sorted(ins) == sorted(JSP.input_specs(jcfg, JSHAPES[name])), name


# ------------------------------------------------------------ the counter
def test_counter_is_exact_for_a_matmul():
    for dev in ("cpu", "meta"):
        a, b = torch.empty(64, 32, device=dev), torch.empty(32, 16, device=dev)
        with cost.OpCounter() as c:
            assert c.track((a, b)) == 64 * 32 * 4 + 32 * 16 * 4
            y = a @ b
            v = y.t()                       # a view: no bytes, no storage
        assert c.flops == 2 * 64 * 32 * 16
        assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
        assert c.live == c.peak == (64 * 32 + 32 * 16 + 64 * 16) * 4
        del y, v
        assert c.live == (64 * 32 + 32 * 16) * 4      # y's storage freed
    with cost.OpCounter() as c:
        t = torch.empty(3, device=META)
    assert c.live == cost.BLOCK and c.bytes == 0 and t.numel() == 3


def _run(fn, args) -> tuple:
    with cost.OpCounter() as c:
        c.track(args)
        fn(*args)
    return c.peak, c.flops, c.bytes


@pytest.mark.parametrize("arch,kind", [("qwen2-0.5b-smoke", "train"),
                                       ("qwen2-0.5b-smoke", "prefill"),
                                       ("mamba2-780m-smoke", "prefill")])
def test_counter_meta_peak_equals_cpu_peak(arch, kind):
    """The same step (plain paths) on meta and on real CPU tensors: the same
    peak, flops and bytes, to the byte."""
    cfg = get_config(arch)
    perf = PerfConfig(use_kernels=False, microbatch=2)
    make = ((lambda: make_train_step(cfg, perf)) if kind == "train"
            else (lambda: make_prefill_step(cfg, 64, perf)))
    counts = []
    for dev in ("cpu", "meta"):
        model, fn = make()
        specs = model.param_specs()
        params = (P.init(torch.Generator().manual_seed(0), specs, dev) if dev == "cpu"
                  else P.tree_map(lambda s: SP.meta(s.shape, s.dtype), specs))
        batch = {"tokens": torch.zeros((4, 64), dtype=torch.int32, device=dev)}
        if kind == "train":
            batch["labels"] = torch.zeros((4, 64), dtype=torch.int32, device=dev)
            args = (params, OPT.init_opt_state(specs, dev), batch)
        else:
            args = (params, batch)
        counts.append(_run(fn, args))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


# ------------------------------------------------------------ kernel wrappers
def _visible_matrix(Sq, Skv, window):
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    vis = kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    return int(vis.sum())


def test_kernel_wrappers_on_meta_report_their_work():
    for Sq, Skv, window in ((128, 128, 0), (64, 300, 0), (300, 300, 64), (7, 5, 0),
                            (512, 4096, 1000)):
        assert flash_ops.visible_pairs(Sq, Skv, window) == _visible_matrix(Sq, Skv, window)
    n0 = (flash_ops.launches, paged_ops.launches, ssd_ops.launches)
    B, S, H, KV, d = 2, 256, 14, 2, 64
    with cost.OpCounter() as c:
        q = torch.empty((B, S, H, d), dtype=torch.bfloat16, device=META)
        k = torch.empty((B, S, KV, d), dtype=torch.bfloat16, device=META)
        out = flash_ops.attention(q, k, k, window=64)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device == META
    nbytes, flops = flash_ops.work(B, S, S, H, KV, d, 64, 2)
    assert (c.flops, c.bytes) == (flops, nbytes) and c.kernels == {"flash_attention": 1}
    assert flops == 4.0 * B * H * d * _visible_matrix(S, S, 64)

    nb, bs, mb = 16, 16, 4
    with cost.OpCounter() as c:
        out = paged_ops.paged_decode_attention(
            torch.empty((B, H, d), device=META), torch.empty((nb, bs, KV, d), device=META),
            torch.empty((nb, bs, KV, d), device=META),
            torch.empty((B, mb), dtype=torch.int32, device=META),
            torch.empty((B,), dtype=torch.int32, device=META))
    assert out.shape == (B, H, d) and out.device == META
    assert (c.bytes, c.flops) == paged_ops.work(B, H, KV, d, mb, [mb * bs] * B, 4)

    b, H2, P_, N, G, Q = 2, 4, 16, 32, 1, 64
    with cost.OpCounter() as c:
        y, h = ssd_ops.ssd_scan(torch.empty((b, S, H2, P_), dtype=torch.bfloat16, device=META),
                                torch.empty((b, S, G, N), dtype=torch.bfloat16, device=META),
                                torch.empty((b, S, G, N), dtype=torch.bfloat16, device=META),
                                torch.empty((b, S, H2), device=META),
                                torch.empty((b, S, H2), device=META), chunk=Q)
    assert (y.shape, h.shape) == ((b, S, H2, P_), (b, H2, P_, N))
    assert y.dtype == h.dtype == torch.float32 and y.device == META
    assert (c.bytes, c.flops) == ssd_ops.work(b, S, H2, P_, N, G, Q, 2)
    # C B^T once per group, the other products once per head
    per_group = 2.0 * b * (S // Q) * Q * Q * N
    assert ssd_ops.work(b, S, H2, P_, N, H2, Q, 2)[1] - c.flops == (H2 - 1) * per_group
    with pytest.raises(ValueError):                 # shapes checked on meta too
        flash_ops.attention(q, torch.empty((B, S, 3, d), dtype=torch.bfloat16,
                                           device=META), k)
    assert (flash_ops.launches, paged_ops.launches, ssd_ops.launches) == n0

    # CPU tensors: the plain versions, unchanged
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 16, n, 8), generator=g) for n in (4, 2, 2))
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert torch.equal(flash_ops.attention(q, k, v), ref.transpose(1, 2))
    kp, vp = (torch.randn((4, 4, 2, 8), generator=g) for _ in range(2))
    table = torch.tensor([[0, 1, -1], [2, 3, -1]], dtype=torch.int32)
    ctx = torch.tensor([5, 8], dtype=torch.int32)
    qd = torch.randn((2, 4, 8), generator=g)
    assert torch.equal(paged_ops.paged_decode_attention(qd, kp, vp, table, ctx),
                       paged_attention_ref(qd, kp, vp, table, ctx))
    x, Bm, dt = (torch.randn(s, generator=g) for s in ((1, 32, 2, 4), (1, 32, 1, 4), (1, 32, 2)))
    da = -dt.abs()
    for a, r in zip(ssd_ops.ssd_scan(x, Bm, Bm, dt, da, chunk=16),
                    ssd_scan_ref(x, Bm, Bm, dt, da, chunk=16)):
        assert torch.equal(a, r)


# ------------------------------------------------------------ full-width cells
def test_qwen2_decode_32k_fits_one_h100():
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", M.make_production_mesh(), "h100",
                          verbose=False)
    assert rec["status"] == "ok" and rec["fits_hbm"] is True
    cfg = get_config("qwen2-0.5b")
    m = make_model(cfg)
    B, S = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    params, caches = P.count_bytes(m.param_specs()), P.count_bytes(m.cache_specs(B, S))
    mem = rec["memory"]
    assert mem["peak_bytes"] >= params + caches
    assert mem["argument_bytes"] >= params + caches
    assert mem["alias_bytes"] >= caches                  # caches updated in place
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    D, H, KV, hd, F, V, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             cfg.d_ff, cfg.vocab_size, cfg.num_layers)
    matmul = L * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F) + D * V
    analytic = 2 * B * matmul + 4 * B * S * H * hd * L   # every slot attended
    assert abs(rec["flops_per_device"] / analytic - 1) < 0.05
    assert rec["kernels"] == {} and rec["perf"]["microbatch"] == 1


def test_jamba_decode_32k_does_not_fit_one_h100():
    rec = dryrun.run_cell("jamba-v0.1-52b", "decode_32k", M.make_production_mesh(), "h100",
                          verbose=False)
    assert rec["status"] == "ok" and rec["fits_hbm"] is False
    assert rec["memory"]["argument_bytes"] > M.HBM_BYTES


def test_fits_leaves_the_context_its_room(monkeypatch):
    """A peak between the usable bytes and the card's whole memory does
    not fit: the CUDA context holds the difference."""
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", M.make_production_mesh(), "h100",
                          verbose=False)
    peak = rec["memory"]["peak_bytes"]
    assert 0 < M.HBM_USABLE < M.HBM_BYTES
    monkeypatch.setattr(M, "HBM_USABLE", peak - 1)
    monkeypatch.setattr(M, "HBM_BYTES", peak + 1)
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", M.make_production_mesh(), "h100",
                          verbose=False)
    assert rec["status"] == "ok" and rec["fits_hbm"] is False


def test_qwen2_long_500k_skips_with_the_reference_reason():
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", M.make_production_mesh(), "h100",
                          verbose=False)
    ok, reason = jax_shape_supported(jax_get_config("qwen2-0.5b"), JSHAPES["long_500k"])
    assert not ok and rec == {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "h100",
                              "status": "skip", "reason": reason}


def test_launchers_dryrun_without_a_gpu(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert serve_launcher.main(["--arch", "qwen2-0.5b", "--dryrun"]) == 0
    assert "qwen2-0.5b x decode_32k: OK" in capsys.readouterr().out
    # one micro-batch, whole-sequence query and loss slices: a short trace
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--out", str(out),
                        "--perf", "microbatch=1", "q_chunk=4096",
                        "xent_chunk=4096"]) == 0
    assert train_launcher.main(["--arch", "qwen2-0.5b", "--production", "--perf",
                                "microbatch=1", "q_chunk=4096", "xent_chunk=4096"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("qwen2-0.5b x train_4k: OK") == 2 and "0 failures" in printed
    import json
    rec = json.loads(out.read_text())
    assert rec["perf"]["microbatch"] == 1 and rec["traced_microbatches"] == 1
    assert rec["shape"] == "train_4k" and rec["status"] == "ok"
