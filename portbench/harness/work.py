"""What the model's work costs by its shapes, from the configuration's
file alone: model FLOPs of a token and the bytes and FLOPs paged decode
attention needs."""
from __future__ import annotations

BF16 = 2


def matmul_params(conf: dict) -> int:
    """Weights one token multiplies through: the attention projections,
    the MLP or its k routed experts and the router, the unembedding."""
    D, H, KV, d = (conf["hidden_size"], conf["num_attention_heads"],
                   conf["num_key_value_heads"], conf["head_dim"])
    attn = D * H * d * 2 + D * KV * d * 2
    if conf.get("num_experts"):
        mlp = conf["num_experts_per_tok"] * 3 * D * conf["moe_intermediate_size"] \
            + D * conf["num_experts"]
    else:
        mlp = 3 * D * conf["intermediate_size"]
    return conf["num_hidden_layers"] * (attn + mlp) + D * conf["vocab_size"]


def token_flops(conf: dict, context: int) -> float:
    """Model FLOPs of one token that attends ``context`` keys (itself
    included): two per weight multiplied, and q.k and p.v over the
    context in every layer."""
    L, H, d = conf["num_hidden_layers"], conf["num_attention_heads"], conf["head_dim"]
    return 2.0 * matmul_params(conf) + 4.0 * context * H * d * L


def paged_attention_work(conf: dict, contexts) -> tuple[float, float]:
    """(bytes, FLOPs) of the paged decode attention of one step over all
    layers: each live row's K and V over its context read once, its q
    read and its output written once, in bfloat16; q.k and p.v over the
    context for every head."""
    L, H, KV, d = (conf["num_hidden_layers"], conf["num_attention_heads"],
                   conf["num_key_value_heads"], conf["head_dim"])
    toks = sum(contexts)
    nbytes = L * (2 * toks * KV * d * BF16 + 2 * len(contexts) * H * d * BF16)
    return float(nbytes), 4.0 * toks * H * d * L
