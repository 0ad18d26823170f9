"""Cell builder: (arch x shape x mesh x perf) -> the port's step function and
its meta-device arguments, the reference's ``launch/build.py``.

Where the reference jits the step and lowers it with abstract arguments,
the port runs the step itself on ``meta`` tensors (an abstract trace:
every op checks shapes and allocates nothing) under ``cost.OpCounter``
(:func:`trace_cell`).

A train cell traces two micro-batches of the production micro-batch, not
all ``n``: from the second on, the accumulator is live and the step's peak
no longer changes, and its flops and bytes are ``n`` times one
micro-batch's loss, gradients and accumulation plus one AdamW update
(with the accumulator's set-up and mean), which :func:`trace_cell`
counts apart.

On a mesh of several cards (the reference's ``16x16`` and ``2x16x16``) a
serving cell's arguments are DTensors whose local shards are meta tensors:
parameters by ``Sharder.spec_shardings``, caches by their specs, tokens
and positions by ``batch_shardings``, under ``perf.partitioning``'s rule
table.  Its ``fn`` is one device's program (``distributed/spmd.py``) on
the local shards (:meth:`Cell.local_args`), traced on this process's rank
of the process group the caller opened.  The sharded train step is not
ported (:class:`NotPorted`).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed.sharding import Sharder, local_shape, placements, rules_for
from repro_torch.distributed.spmd import Spmd
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models import params as P
from repro_torch.models.lm import torch_dtype
from repro_torch.training import optimizer as OPT
from repro_torch.training.steps import (grad_accumulator, make_decode_step,
                                        make_prefill_step, make_train_step,
                                        mean_grads)

TRACED_MICROBATCHES = 2


class NotPorted(Exception):
    """A cell the port does not trace yet (the train step on a mesh)."""


def default_perf(cfg: ModelConfig, shape: ShapeConfig, base: PerfConfig = BASELINE,
                 *, data: int = 1) -> PerfConfig:
    """Napkin-math microbatch default: keep the per-device per-scan-step
    activation boundary (m * S * D * 2 / data) under ~128 MB.  ``data`` is
    the mesh's data axis (1 on one card; the reference's pods have 16)."""
    perf = base
    if shape.kind == "train":
        budget = 128e6
        m_max = max(1, int(budget * data / (shape.seq_len * cfg.d_model * 2)))
        m = 1 << int(math.log2(m_max)) if m_max >= 1 else 1
        m = min(m, shape.global_batch)
        while shape.global_batch % m:
            m //= 2
        n_micro = shape.global_batch // m
        perf = dataclasses.replace(perf, microbatch=n_micro)
    return perf


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    perf: PerfConfig             # the production perf (train: all n micro-batches)
    fn: Any                      # the step function traced
    args: tuple                  # its meta arguments
    model: Any
    traced_microbatches: int = 0     # train: micro-batches ``fn`` runs
    once: Any = None             # train: (params, opt_state) -> the update alone
    spmd: Any = None             # a mesh of several cards: the step's Spmd

    def local_args(self) -> tuple:
        """The arguments ``fn`` takes: the local shards of DTensor ones."""
        if self.spmd is None:
            return self.args
        return tuple(P.tree_map(lambda t: t.to_local(), a) for a in self.args)


def _meta_params(pspecs):
    return P.tree_map(lambda s: SP.meta(s.shape, s.dtype), pspecs)


def _dtensor(t, spec, sp: Spmd):
    """A DTensor of ``t``'s global shape and dtype laid out by ``spec``, its
    local shard a meta tensor."""
    local = SP.meta(local_shape(tuple(t.shape), spec, sp.sizes), t.dtype)
    return DTensor.from_local(local, sp.mesh, placements(spec, sp.mesh),
                              run_check=False, shape=tuple(t.shape),
                              stride=t.stride())


def _sharded(tree, specs, sp: Spmd):
    return P.tree_map(lambda t, spec: _dtensor(t, spec, sp), tree, specs)


def real_local_args(cell: Cell, device, generator: torch.Generator) -> tuple:
    """Real tensors in the shapes and dtypes of ``cell.local_args()`` on
    ``device``: floating leaves drawn at std 0.02, int32 inputs random token
    ids; a decode step runs at the context's last position over empty
    caches (zeros; -1 in a ring's positions)."""
    cfg, shape = cell.cfg, cell.shape

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=generator,
                                 device=device, dtype=torch.int32)
        return (torch.randn(t.shape, generator=generator, device=device)
                * 0.02).to(t.dtype)

    def empty(tree, name=None):
        if isinstance(tree, dict):
            return {k: empty(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [empty(v) for v in tree]
        return torch.full(tree.shape, -1 if name == "pos" else 0, dtype=tree.dtype,
                          device=device)

    local = cell.local_args()
    params = P.tree_map(real, local[0])
    if shape.kind == "decode":
        _, tokens, pos, caches = local
        return (params, real(tokens),
                torch.full(pos.shape, shape.seq_len - 1, dtype=torch.int32, device=device),
                empty(caches))
    return params, {k: real(v) for k, v in local[1].items()}


def build_sharded_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, perf: PerfConfig,
                       device_type: str = "cpu") -> Cell:
    """A serving cell on a mesh of several cards: one device's program and
    DTensor arguments, on the process group the caller opened at
    ``mesh.size`` ranks (the dry run: the fake backend, at rank 0)."""
    if shape.kind == "train":
        raise NotPorted("the sharded train step (ZeRO-1 moments, gradient "
                        "constraints, micro-batch split, vocab-sharded "
                        "cross-entropy) is the next slice of the port")
    sharder = Sharder(mesh, rules_for(perf.partitioning))
    sp = Spmd(sharder, M.device_mesh(mesh, device_type), batch=shape.global_batch,
              kv_len=shape.seq_len)
    if shape.kind == "prefill":
        model, fn = make_prefill_step(cfg, shape.seq_len, perf, shd=sp)
        pspecs = model.param_specs()
        batch = SP.batch_specs(cfg, shape, with_labels=False)
        args = (_sharded(_meta_params(pspecs), sharder.spec_shardings(pspecs), sp),
                _sharded(batch, sharder.batch_shardings(batch), sp))
        return Cell(cfg, shape, perf, fn, args, model, spmd=sp)
    model, fn = make_decode_step(cfg, perf, shd=sp)
    pspecs = model.param_specs()
    d = SP.decode_specs(cfg, shape, model, perf)
    B = shape.global_batch
    args = (_sharded(_meta_params(pspecs), sharder.spec_shardings(pspecs), sp),
            _dtensor(d["tokens"], sharder.spec_for((B, 1), ("batch", None)), sp),
            _dtensor(d["pos"], sharder.spec_for((B,), ("batch",)), sp),
            _sharded(d["caches"], sharder.spec_shardings(d["cache_param_specs"]), sp))
    return Cell(cfg, shape, perf, fn, args, model, spmd=sp)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               perf: PerfConfig | None = None, *, device_type: str = "cpu") -> Cell:
    """The step of ``shape.kind`` at the production shape: on one card, or
    one device's program on a mesh of several (:func:`build_sharded_cell`,
    whose mesh is built for ``device_type``)."""
    perf = perf if perf is not None else default_perf(
        cfg, shape, data=mesh.shape.get("data", 1))
    if mesh.size != 1:
        return build_sharded_cell(cfg, shape, mesh, perf, device_type)

    if shape.kind == "train":
        n = perf.microbatch
        traced = min(n, TRACED_MICROBATCHES)
        rows = shape.global_batch // n * traced
        model, fn = make_train_step(cfg, dataclasses.replace(perf, microbatch=traced))
        pspecs = model.param_specs()
        batch = SP.batch_specs(cfg, dataclasses.replace(shape, global_batch=rows),
                               with_labels=True)
        adt = torch_dtype(perf.accum_dtype)

        def once(params, opt_state):
            grads = mean_grads(grad_accumulator(params, adt), traced)
            return OPT.apply_updates(params, grads, opt_state, OPT.AdamWConfig())

        return Cell(cfg, shape, perf, fn,
                    (_meta_params(pspecs), OPT.init_opt_state(pspecs, SP.META), batch),
                    model, traced, once)

    if shape.kind == "prefill":
        model, fn = make_prefill_step(cfg, shape.seq_len, perf)
        batch = SP.batch_specs(cfg, shape, with_labels=False)
        return Cell(cfg, shape, perf, fn,
                    (_meta_params(model.param_specs()), batch), model)

    model, fn = make_decode_step(cfg, perf)
    d = SP.decode_specs(cfg, shape, model, perf)
    return Cell(cfg, shape, perf, fn,
                (_meta_params(model.param_specs()), d["tokens"], d["pos"], d["caches"]),
                model)


def trace_cell(cell: Cell) -> dict:
    """Run ``cell.fn`` on its meta arguments under ``cost.OpCounter``, with
    the garbage collector held off (a cycle's tensors live to the end,
    as they would on the card between collections).  Returns the memory
    record (argument, output, temp, alias and peak bytes, in the
    reference's names: alias = the state updated in place, params and
    moments in training, caches in decode), flops and bytes (of the whole
    step: all ``n`` micro-batches), those of the traced call alone, the
    kernel wrappers' meta calls and the trace's seconds."""
    gc.collect()
    gc.disable()
    args = cell.local_args()
    try:
        t0 = time.perf_counter()
        with cost.OpCounter() as c:
            c.track(args)
            out = cell.fn(*args)
        trace_s = time.perf_counter() - t0
        flops, nbytes = c.flops, c.bytes
        if cell.traced_microbatches > 1:
            with cost.OpCounter() as u:
                cell.once(*cell.args[:2])
            n, k = cell.perf.microbatch, cell.traced_microbatches
            flops = n * (flops - u.flops) / k + u.flops
            nbytes = n * (nbytes - u.bytes) / k + u.bytes
    finally:
        gc.enable()
    ins, outs = cost.storages(args), cost.storages(out)
    arg, outb = sum(ins.values()), sum(outs.values())
    alias = sum(b for key, b in outs.items() if key in ins)
    memory = {"argument_bytes": arg, "output_bytes": outb,
              "temp_bytes": c.peak - (arg + outb - alias), "alias_bytes": alias,
              "peak_bytes": c.peak}
    return {"memory": memory, "flops": flops, "bytes": nbytes,
            "traced_flops": c.flops, "traced_bytes": c.bytes,
            "kernels": dict(c.kernels), "collectives": dict(c.collectives),
            "trace_s": trace_s}
