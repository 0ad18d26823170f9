"""Meta-device stand-ins for every model input (dry-run path), the
reference's ``launch/specs.py``: where it returns ``ShapeDtypeStruct``s
these are tensors on ``torch.device("meta")``, which carry a shape, a dtype
and strides and allocate nothing.

Shapes are exact production shapes.  ``decode`` cells trace
``decode_step`` (one new token against a cache sized to shape.seq_len);
``train``/``prefill`` trace full sequences.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import params as P
from repro_torch.models.lm import make_model, torch_dtype

META = torch.device("meta")
i32 = torch.int32
bf16 = torch.bfloat16


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool) -> dict:
    B, S = shape.global_batch, shape.seq_len
    text = S - (cfg.num_vision_tokens or 0)
    d = {"tokens": meta((B, text), i32)}
    if with_labels:
        d["labels"] = meta((B, text), i32)
    if cfg.num_vision_tokens:
        d["patches"] = meta((B, cfg.num_vision_tokens, cfg.d_model), bf16)
    if cfg.is_encoder_decoder:
        d["frames"] = meta((B, cfg.encoder_seq, cfg.d_model), bf16)
    return d


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model=None, perf=None) -> dict:
    """tokens/pos/caches meta tensors for one decode step at context S; the
    caches' bf16 leaves in ``perf.kv_dtype``."""
    B, S = shape.global_batch, shape.seq_len
    model = model or make_model(cfg, *([perf] if perf else []))
    cache_specs = model.cache_specs(B, S)
    kv_dtype = torch_dtype(perf.kv_dtype) if perf is not None else bf16

    def to_meta(s: P.ParamSpec):
        return meta(s.shape, kv_dtype if s.dtype == bf16 else s.dtype)

    return {
        "tokens": meta((B, 1), i32),
        "pos": meta((B,), i32),
        "caches": P.tree_map(to_meta, cache_specs),
        "cache_param_specs": cache_specs,  # for sharding resolution
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model=None, perf=None) -> dict:
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    return decode_specs(cfg, shape, model, perf)
