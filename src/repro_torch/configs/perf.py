"""Performance knobs.

Everything here changes how a pass runs but never the math (up to
floating-point rounding, remat recomputation and the gradient
accumulator's dtype).  ``use_kernels`` is the one switch between the
hand-written CUDA kernels (``kernels/``) and the plain tensor path the
reference model takes without its Pallas kernels; training never takes
the kernels, which have no backward.

``partitioning`` names the rule table (``distributed/sharding.rules_for``)
of a step on a mesh of several cards.  The reference's ``use_pallas``
(here ``use_kernels``), ``pallas_interpret``, ``decode_unroll`` and
``donate`` have no counterpart: there is no interpret mode, no scanned
layer stack to unroll and no buffer donation in eager PyTorch (the
optimizer updates the parameters in place instead).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    # kernels: dense prefill -> flash attention, paged decode -> paged
    # attention.  On CPU tensors the kernel ops run their plain versions.
    use_kernels: bool = True
    # queries per slice of the plain attention paths: each slice's f32
    # scores are (B, heads, q_chunk, keys)
    q_chunk: int = 512
    # kv cache dtype of prefill caches and paged pools ("bfloat16" | "float32")
    kv_dtype: str = "bfloat16"
    # loss: sequence positions per slice of the chunked cross-entropy, so
    # one (B, xent_chunk, vocab) f32 logits slice is alive at a time
    xent_chunk: int = 512
    # training memory: recompute each layer group in the backward pass
    # ("full"), keep the matmul outputs and recompute the rest ("dots"),
    # or keep every activation ("none")
    remat: str = "full"
    microbatch: int = 1            # grad-accumulation steps over the global batch
    accum_dtype: str = "bfloat16"  # grad accumulator dtype (bfloat16 | float32)
    # sharding rule table on a mesh of several cards: tp | zero3 | dp
    partitioning: str = "tp"


BASELINE = PerfConfig()


def with_overrides(perf: PerfConfig, **kw) -> PerfConfig:
    return dataclasses.replace(perf, **kw)
