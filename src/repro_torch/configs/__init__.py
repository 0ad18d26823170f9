"""Architecture registry: every arch of the reference (``<arch>-smoke`` too),
and the (arch x shape) cells of the production dry run."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    reduced,
    shape_supported,
)

_ARCH_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma3-27b": "gemma3_27b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma-2b": "gemma_2b",
    "gemma3-4b": "gemma3_4b",
    "paligemma-3b": "paligemma_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return reduced(get_config(arch[: -len("-smoke")]))
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def arch_shape_cells(include_skipped: bool = False):
    """All (arch, shape) cells; 40 total, with documented skips filtered."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, reason = shape_supported(cfg, shape)
            if ok or include_skipped:
                yield arch, shape.name, ok, reason
