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
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.launch import cost
from repro_torch.launch import specs as SP
from repro_torch.models import params as P
from repro_torch.models.lm import torch_dtype
from repro_torch.training import optimizer as OPT
from repro_torch.training.steps import (grad_accumulator, make_decode_step,
                                        make_prefill_step, make_train_step,
                                        mean_grads)

TRACED_MICROBATCHES = 2


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


def _meta_params(pspecs):
    return P.tree_map(lambda s: SP.meta(s.shape, s.dtype), pspecs)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               perf: PerfConfig | None = None) -> Cell:
    """The step of ``shape.kind`` at the production shape, on one card."""
    if mesh.size != 1:
        raise ValueError(f"mesh {dict(mesh.shape)}: the port traces one card "
                         "(no collectives)")
    perf = perf if perf is not None else default_perf(
        cfg, shape, data=mesh.shape.get("data", 1))

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
    try:
        t0 = time.perf_counter()
        with cost.OpCounter() as c:
            c.track(cell.args)
            out = cell.fn(*cell.args)
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
    args, outs = cost.storages(cell.args), cost.storages(out)
    arg, outb = sum(args.values()), sum(outs.values())
    alias = sum(b for key, b in outs.items() if key in args)
    memory = {"argument_bytes": arg, "output_bytes": outb,
              "temp_bytes": c.peak - (arg + outb - alias), "alias_bytes": alias,
              "peak_bytes": c.peak}
    return {"memory": memory, "flops": flops, "bytes": nbytes,
            "traced_flops": c.flops, "traced_bytes": c.bytes,
            "kernels": dict(c.kernels), "trace_s": trace_s}
