"""paligemma-3b [arXiv:2407.07726; hf google/paligemma-3b-pt-224].

SigLIP vision tower (STUB per brief: input_specs provides precomputed patch
embeddings, 256 tokens @ d_model) + gemma-2b text backbone, vocab=257216.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_activation="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embed=True,
    num_vision_tokens=256,
    norm_eps=1e-6,
)
