"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*1536 = 3072, headdim 64 -> 48 SSD heads, 1 group, conv4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    norm_eps=1e-5,
)
