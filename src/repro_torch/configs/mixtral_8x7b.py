"""mixtral-8x7b [arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1].

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=32000; 8 experts
top-2 on every layer; sliding-window attention 4096.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                 # every MLP is MoE
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_every=1,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
)
