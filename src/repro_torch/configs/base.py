"""Model configuration.

Each architecture contributes one module in this package exporting
``CONFIG`` (exact published dims) — see the per-arch files.  ``reduced()``
derives a structure-preserving tiny variant for CPU smoke tests.  The
fields mirror the reference package's config field for field.
``SHAPES`` are the production input shapes that the dry run
(``launch/dryrun.py``) traces each arch at.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # attention flavour
    attn_bias: bool = False            # qwen2: bias on QKV
    qk_norm: bool = False              # qwen3: RMSNorm on q/k heads
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    use_rope: bool = True              # whisper uses learned positions
    sliding_window: int = 0            # uniform SWA (mixtral) — 0 = off
    local_window: int = 0              # gemma3 local-layer window
    local_ratio: int = 0               # gemma3: N local layers per 1 global
    mlp_activation: str = "silu"       # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    scale_embed: bool = False          # gemma family: embed * sqrt(d_model)
    max_position: int = 1_048_576      # rope archs: unbounded in practice

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1                 # MoE replaces MLP on layers i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (jamba): attention on layers i % attn_every == attn_offset; else SSM
    attn_every: int = 0
    attn_offset: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500            # whisper 30s @ 50Hz after conv stub

    # vlm (paligemma): prefix of precomputed patch embeddings
    num_vision_tokens: int = 0

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, i: int) -> str:
        """'attn' | 'attn_local' | 'ssm' for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every:  # hybrid
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        if self.local_ratio:  # gemma3: pattern [local x N, global] repeating
            return "attn" if (i % (self.local_ratio + 1)) == self.local_ratio else "attn_local"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.num_experts:
            return False
        return i % self.moe_every == self.moe_offset

    def window_for(self, kind: str) -> int:
        """Effective attention window for a layer kind (0 = unbounded)."""
        if kind == "attn_local":
            return self.local_window
        return self.sliding_window

    # rough parameter counts (docs/roofline use exact spec counts instead)
    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        if self.family != "ssm":
            assert self.num_heads and self.head_dim
            if self.num_kv_heads:
                assert self.num_heads % self.num_kv_heads == 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic / bounded-window attention).
_SUBQUADRATIC = {
    "mamba2-780m", "jamba-v0.1-52b", "mixtral-8x7b", "gemma3-27b", "gemma3-4b",
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not); the reasons are the reference's, word
    for word (its DESIGN.md §4 documents the skips)."""
    if shape.name == "long_500k" and cfg.name not in _SUBQUADRATIC:
        return False, "pure full-attention arch: 500k decode KV unbounded (DESIGN.md §4)"
    if cfg.is_encoder_decoder and shape.name == "long_500k":
        return False, "enc-dec decoder context architecturally capped"
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Structure-preserving tiny variant for CPU smoke tests.

    Keeps: family, layer-kind pattern period, GQA ratio, MoE top-k, gating
    flavour.  Shrinks: widths, vocab, expert count, state dims.
    """
    # keep at least one full pattern period so hetero archs exercise all kinds
    period = 1
    if cfg.attn_every:
        period = cfg.attn_every
    elif cfg.local_ratio:
        period = cfg.local_ratio + 1
    if cfg.num_experts:
        period = max(period, 2 * cfg.moe_every)
    layers = max(2, period)

    n_heads = max(2, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    kv = 0
    if cfg.num_kv_heads:
        ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
        kv = max(1, n_heads // min(ratio, n_heads))
    n_exp = min(cfg.num_experts, 4) if cfg.num_experts else 0
    topk = min(cfg.experts_per_token, n_exp) if n_exp else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        d_model=64,
        num_heads=n_heads,
        num_kv_heads=kv,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=n_exp,
        experts_per_token=topk,
        moe_d_ff=96 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        encoder_seq=24 if cfg.is_encoder_decoder else cfg.encoder_seq,
        num_vision_tokens=8 if cfg.num_vision_tokens else 0,
        max_position=4096,
    )


def model_flops_per_token(cfg: ModelConfig, n_params_active: int) -> float:
    """MODEL_FLOPS/token = 6*N_active (train) — roofline 'useful flops' basis."""
    return 6.0 * n_params_active
