"""gemma3-4b [hf google/gemma-3-4b-pt family].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; 5:1 local:global
(window 1024); GeGLU; head_dim=256; 128k ctx.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
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
