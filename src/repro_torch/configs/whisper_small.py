"""whisper-small [arXiv:2212.04356].

Enc-dec: 12L encoder + 12L decoder, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  Conv frontend is a STUB (input_specs provides precomputed frame
embeddings, 1500 x d_model).  Learned positions, GELU MLP (non-gated).

NOTE (DESIGN.md §4): published max_target_positions is 448; the assigned
decode/prefill stress shapes size the decoder positional table to the
requested seq_len (backbone-only stress test per the brief).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    num_encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_activation="gelu_plain",
    use_rope=False,
    is_encoder_decoder=True,
    encoder_seq=1500,
    tie_embeddings=True,
    norm_eps=1e-5,
    max_position=32768,
)
