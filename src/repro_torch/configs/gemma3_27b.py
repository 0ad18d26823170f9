"""gemma3-27b [hf google/gemma-3-27b-pt family].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; 5 local : 1 global
(window 1024, local rope theta 10k, global 1M); GeGLU; head_dim=128; 128k ctx.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    mlp_activation="gelu",
    local_ratio=5,
    local_window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    scale_embed=True,
    qk_norm=True,
    norm_eps=1e-6,
)
