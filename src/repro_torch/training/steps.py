"""Step functions: train_step / prefill_step / decode_step, the reference's
``training/steps.py``.

``make_train_step`` supports gradient accumulation (``perf.microbatch``):
the global batch is split into ``n`` micro-batches along its first axis,
whose gradients are summed in ``perf.accum_dtype``.  Gradients come from
autograd through the plain paths; the parameters are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.models import params as P
from repro_torch.models.layers import noop_shd
from repro_torch.models.lm import make_model, torch_dtype
from repro_torch.training.optimizer import AdamWConfig, apply_updates

f32 = torch.float32


def _split_micro(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n batches of (B//n, ...), in order."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not split "
                             f"into {n} micro-batches")
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def loss_and_grads(model, params, batch):
    """(loss, metrics, gradient tree) of ``model.loss(params, batch)`` by
    autograd.  The gradients are taken through leaves that share the
    parameters' storage, so the caller's tensors keep requires_grad False;
    a parameter the loss does not reach gets a zero gradient, as in JAX."""
    live = P.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, P.tree_leaves(live), materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            P.tree_map(lambda _: next(it), live))


def grad_accumulator(params, dtype):
    """Zeros shaped like the parameters, in the accumulator's dtype."""
    return P.tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device),
                      params)


def mean_grads(acc, n: int):
    """The summed gradients of ``n`` micro-batches -> their mean, in f32
    and cast back to the accumulator's dtype."""
    inv = 1.0 / n
    return P.tree_map(lambda g: (g.to(f32) * inv).to(g.dtype), acc)


def make_train_step(cfg: ModelConfig, perf: PerfConfig = BASELINE,
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """Returns (model, train_step); ``train_step(params, opt_state, batch)``
    -> (params, opt_state, metrics), the parameters and moments updated in
    place."""
    model = make_model(cfg, perf)
    adt = torch_dtype(perf.accum_dtype)

    def train_step(params, opt_state, batch):
        if perf.microbatch > 1:
            acc = grad_accumulator(params, adt)
            lsum = torch.zeros((), dtype=f32, device=batch["tokens"].device)
            tok = 0
            for mb in _split_micro(batch, perf.microbatch):
                loss, metrics, grads = loss_and_grads(model, params, mb)
                acc = P.tree_map(lambda a, g: a + g.to(adt), acc, grads)
                lsum, tok = lsum + loss, tok + metrics["tokens"]
            grads = mean_grads(acc, perf.microbatch)
            loss = lsum * (1.0 / perf.microbatch)
            metrics = {"loss": loss, "tokens": tok}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
            metrics = dict(metrics, loss=loss)
        params, opt_state, stats = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, dict(metrics, **stats)

    return model, train_step


def make_prefill_step(cfg: ModelConfig, max_len: int, perf: PerfConfig = BASELINE,
                      shd=noop_shd):
    """``shd``: the sharding hook; a ``distributed.spmd.Spmd`` makes the step
    the program of one device of its mesh, on that device's shards."""
    model = make_model(cfg, perf)

    def prefill_step(params, batch):
        logits, caches = model.prefill(params, batch, max_len, shd=shd)
        return logits.argmax(dim=-1), logits, caches

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, perf: PerfConfig = BASELINE, shd=noop_shd):
    model = make_model(cfg, perf)

    def decode_step(params, tokens, pos, caches):
        logits, caches = model.decode_step(params, tokens, pos, caches, shd=shd)
        return logits.argmax(dim=-1), logits, caches

    return model, decode_step
