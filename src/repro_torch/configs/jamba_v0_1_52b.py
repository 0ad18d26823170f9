"""jamba-v0.1-52b [arXiv:2403.19887; hf ai21labs/Jamba-v0.1].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; Mamba:attn 7:1
(attention on layer 4 of each 8-layer Jamba block); MoE 16e top-2 every
2nd layer.  SSM: d_state=16, conv4, expand 2.

NOTE (DESIGN.md §2): Jamba uses Mamba-1 selective scan; we implement its SSM
layers with the Mamba-2/SSD formulation (multihead, scalar-per-head decay),
which the SSD paper shows is the hardware-efficient equivalent class.  State
size matches the published d_state=16.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    use_rope=False,  # Jamba attention has no positional encoding
    tie_embeddings=False,
    norm_eps=1e-6,
)
