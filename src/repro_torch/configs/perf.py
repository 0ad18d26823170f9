"""Performance knobs.

Everything here changes how the forward pass runs but never the math (up to
floating-point rounding).  ``use_kernels`` is the one switch between the
hand-written CUDA kernels (``kernels/``) and the plain tensor path the
reference model takes without its Pallas kernels.
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


BASELINE = PerfConfig()


def with_overrides(perf: PerfConfig, **kw) -> PerfConfig:
    return dataclasses.replace(perf, **kw)
