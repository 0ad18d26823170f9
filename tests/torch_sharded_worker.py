"""One rank of the sharded-program tests (tests/test_torch_sharded.py):
four ranks over gloo on a (data 2, model 2) CPU mesh.  Imports no JAX, so
the spawned processes start on torch alone.

For each arch (a registered one or one of ``VARIANTS``) the parent saves
``<arch>.in.pt`` (the port's f32 weights, converted from the reference's
init, and the inputs: tokens, a vlm's patches, an encoder's frames); each
rank writes
``<arch>.<rank>.pt``:

- ``rows``: the (offset, count) of its batch rows;
- ``prefill`` / ``decode``: its rows of the sharded step's logits (whole
  over the vocabulary), the decode step reading the one-card prefill's
  caches cut to the rules' layout;
- ``one_card``: the unsharded port's prefill and decode logits of the
  whole batch; ``own``: of the rank's rows alone (the same products'
  shapes: with the reference's init, a row alone and in a batch of 4 can
  differ by more than 1e-5 in the unsharded port itself);
- ``layouts``: for each of ``LAYOUTS`` (another rule table, or one row,
  whose caches put their slots on ``data``), the same parity runs on the
  first ``rows`` rows.
"""
import dataclasses
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.distributed.sharding import Sharder, rules_for
from repro_torch.distributed.spmd import Spmd
from repro_torch.launch import mesh as M
from repro_torch.models import params as P
from repro_torch.models.lm import make_model

WORLD = 4
MESH = {"data": 2, "model": 2}
B, S, L = 4, 40, 48          # rows, prompt tokens, cache slots
PARITY_PERF = PerfConfig(kv_dtype="float32")
# configs of the tests' own: (arch, fields replaced).  Three experts do not
# divide the model axis, so the MoE's hidden width (``moe_mlp``) runs
# tensor-parallel in their place.
VARIANTS = {"mixtral-8x7b-smoke-e3": ("mixtral-8x7b-smoke", {"num_experts": 3})}
# (rule table, rows) of the extra layouts of each arch's parity runs
LAYOUTS = {"qwen2-0.5b-smoke": [("dp", 4)],
           "qwen3-moe-30b-a3b-smoke": [("zero3", 4), ("tp", 1)],
           "mamba2-780m-smoke": [("tp", 1)],
           "gemma3-27b-smoke": [("zero3", 1), ("tp", 1)],
           "whisper-small-smoke": [("zero3", 4), ("tp", 1)],
           "paligemma-3b-smoke": [("tp", 1)],
           "jamba-v0.1-52b-smoke": [("zero3", 4), ("tp", 1)],
           "mixtral-8x7b-smoke-e3": [("tp", 1)]}


def config(name: str, get=get_config):
    """The config of ``name``: a registered arch or one of ``VARIANTS``
    (``get`` the registry to read it from)."""
    arch, fields = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get(arch), **fields)


def _parity(arch: str, data: dict, sp: Spmd) -> dict:
    cfg = config(arch)
    model = make_model(cfg, PARITY_PERF)
    sh, B = sp.sharder, sp.batch
    params = data["params"]
    batch = {k: v[:B] for k, v in data["batch"].items()}
    local = P.tree_map(sp.shard, params, sh.spec_shardings(model.param_specs()))
    lbatch = {k: sp.shard(v, s) for (k, v), s in
              zip(batch.items(), sh.batch_shardings(batch).values())}
    tok, pos = data["tok"][:B], data["pos"][:B]
    off, n = sp.part(B, sp.batch_axes)
    with torch.no_grad():
        ref_logits, ref_caches = model.prefill(params, batch, L)
        logits, _ = model.prefill(local, lbatch, L, shd=sp)
        caches = P.tree_map(sp.shard, ref_caches,
                            sh.spec_shardings(model.cache_specs(B, L)))
        ref_dec, _ = model.decode_step(params, tok, pos, ref_caches)
        dec, _ = model.decode_step(local, sp.shard(tok, sh.spec_for((B, 1), ("batch", None))),
                                   sp.shard(pos, sh.spec_for((B,), ("batch",))),
                                   caches, shd=sp)
        own_logits, own_caches = model.prefill(
            params, {k: v[off:off + n] for k, v in batch.items()}, L)
        own_dec, _ = model.decode_step(params, tok[off:off + n], pos[off:off + n],
                                       own_caches)
    return {"rows": (off, n), "prefill": logits, "decode": dec,
            "one_card": {"prefill": ref_logits, "decode": ref_dec},
            "own": {"prefill": own_logits, "decode": own_dec}}


def run(rank: int, store: str, out_dir: str, archs: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        out = Path(out_dir)
        mesh = M.LogicalMesh(MESH)
        dmesh = M.device_mesh(mesh)
        for arch in archs:
            data = torch.load(out / f"{arch}.in.pt")
            res = _parity(arch, data, Spmd(Sharder(mesh, rules_for("tp")), dmesh,
                                           batch=B, kv_len=L))
            res["layouts"] = {
                (part, rows): _parity(arch, data, Spmd(Sharder(mesh, rules_for(part)),
                                                       dmesh, batch=rows, kv_len=L))
                for part, rows in LAYOUTS[arch]}
            torch.save(res, out / f"{arch}.{rank}.pt")
    finally:
        dist.destroy_process_group()
