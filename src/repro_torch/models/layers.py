"""Functional layers of the port: the subset of the reference's
``models/layers.py`` that dense GQA decoders (qwen2) and MoE decoders with
q/k RMSNorm (qwen3-moe) run.

Conventions follow the reference: activations in the parameter dtype,
softmax and norm statistics in f32, attention scores accumulated in f32
(``preferred_element_type=f32`` there), layouts (B, S, heads, head_dim).
KV caches are dicts of tensors that the cache writers update in place;
every write that the reference drops (``mode="drop"`` or a select against
the old cache) is masked here, so the entries it leaves alone stay
bit-identical.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

f32 = torch.float32
NEG = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("norm",), dtype=f32, init="zeros")}


def rmsnorm(p, x, eps: float, *, plus_one: bool = True):
    """RMSNorm with (1 + scale) parameterisation (scale initialised at zero
    is the identity scale of one)."""
    xf = x.to(f32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = p["scale"] + 1.0 if plus_one else p["scale"]
    return (y * w).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding (half-rotation / NeoX style)
# ---------------------------------------------------------------------------

def rope_angles(positions, d: int, theta: float):
    """(cos, sin) of the rotation angles, (..., S, 1, d/2) f32.  The same for
    q and k and for every layer, so a forward pass computes them once."""
    half = d // 2
    exps = -torch.arange(0, half, dtype=f32, device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=f32, device=positions.device), exps)
    ang = positions[..., None].to(f32) * freq                  # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # fan_in is the contracted size: the reference's rule (second-to-last
    # dim) would scale q and k by the head count and make the softmax of
    # random weights nearly one-hot
    specs = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "qkv"), fan_in=D),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "qkv"), fan_in=D),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "qkv"), fan_in=D),
        "wo": ParamSpec((H, hd, D), ("heads", "qkv", "embed"), fan_in=H * hd),
    }
    if cfg.attn_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "qkv"), init="zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "qkv"), init="zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "qkv"), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_specs(hd)
        specs["k_norm"] = rmsnorm_specs(hd)
    return specs


def _proj(x, w):
    """x (B,S,D) @ w (D,heads,hd) -> (B,S,heads,hd)."""
    D, n, hd = w.shape
    return (x @ w.reshape(D, n * hd)).view(*x.shape[:-1], n, hd)


def _project_qkv(p, x, cfg: ModelConfig, positions, theta: float, *, angles=None):
    """``angles``: precomputed ``rope_angles(positions, head_dim, theta)``."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = angles if angles is not None else rope_angles(
            positions, q.shape[-1], theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _mha_chunk(q, k, v, mask, scale):
    """One (q-chunk, kv-slab) attention with full-row softmax.

    q: (B,cq,H,d)  k,v: (B,sk,KV,d)  mask: (B or 1, cq, sk) bool or None."""
    B, cq, H, d = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, cq, KV, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32)) * scale
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG).to(f32)            # (B|1, cq, sk)
        scores = scores + bias[:, None, None, :, :]
    m = scores.amax(dim=-1, keepdim=True).clamp(min=-1e29)   # guard masked rows
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    w = (e / s.clamp(min=1e-30)).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(B, cq, H, d)


def attention_full(q, k, v, *, causal: bool, window: int = 0,
                   scale: float | None = None):
    """Attention over full sequences (prefill); prompts are bounded by the
    largest prefill bucket, so one slab covers every query.

    q: (B,Sq,H,d); k,v: (B,Skv,KV,d), q positions == kv positions."""
    Sq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    mask = None
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        mask = mask[None]
    return _mha_chunk(q, k, v, mask, scale)


def attention_decode(q, k_cache, v_cache, kv_mask, scale: float | None = None):
    """Single-step decode attention.

    q: (B,1,H,d); caches: (B,S,KV,d); kv_mask: (B,S) bool valid slots."""
    B, _, H, d = q.shape
    KV = k_cache.shape[2]
    rep = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, KV, rep, d)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg.to(f32), k_cache.to(f32)) * scale
    scores = torch.where(kv_mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG))
    m = scores.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    e = torch.exp(scores - m)
    w = (e / e.sum(-1, keepdim=True).clamp(min=1e-30)).to(v_cache.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", w, v_cache)
    return out.reshape(B, 1, H, d)


def attn_out(p, ctx):
    """ctx (B,S,H,hd) @ wo (H,hd,D) -> (B,S,D)."""
    H, hd, D = p["wo"].shape
    return ctx.reshape(*ctx.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, D)


# ---------------------------------------------------------------------------
# KV caches (global layers: slot == absolute position)
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: ModelConfig, batch: int, length: int) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("batch", "act_kv", "kv_heads", "qkv")
    return {"k": ParamSpec((batch, length, KV, hd), axes, init="zeros"),
            "v": ParamSpec((batch, length, KV, hd), axes, init="zeros")}


def cache_write_prefill(cache, k, v):
    """Write a full prefill's k/v at positions 0..S-1 of a cache whose length
    may exceed S.  Right-padded rows need no mask: pad slots sit at positions
    >= true_len, and decode overwrites slot p when position p becomes
    visible."""
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cache


def chunk_write_slots(pos0, n_valid, chunk: int):
    """(flat chunk index, row, slot) of the valid positions of a chunk write;
    one device sync, computed once per forward pass."""
    ar = torch.arange(chunk, device=pos0.device)[None, :]
    sel = (ar < n_valid[:, None]).reshape(-1).nonzero()[:, 0]
    rows = sel // chunk
    return sel, rows, pos0.long()[rows] + sel % chunk


def cache_write_chunk(cache, k, v, pos0, n_valid, *, slots=None):
    """Append a chunk of C tokens at per-row positions pos0 .. pos0+n_valid-1.

    k/v: (B,C,KV,hd) right-padded chunk projections; pos0/n_valid (B,).
    Pad positions and rows with n_valid == 0 are not written.  ``slots``:
    precomputed ``chunk_write_slots``."""
    if slots is None:
        slots = chunk_write_slots(pos0, n_valid, k.shape[1])
    sel, rows, pos = slots
    cache["k"][rows, pos] = k.reshape(-1, *k.shape[2:])[sel].to(cache["k"].dtype)
    cache["v"][rows, pos] = v.reshape(-1, *v.shape[2:])[sel].to(cache["v"].dtype)
    return cache


def attention_chunk(q, k, v, cache, pos0, *, scale: float | None = None):
    """Chunked-prefill attention: queries at positions pos0+i attend the
    cache as written by previous chunks (positions < pos0) plus this chunk's
    own k/v causally.  ``cache`` is the cache *before* this chunk's write."""
    B, C, H, d = q.shape
    L = cache["k"].shape[1]
    dev = q.device
    qpos = pos0.long()[:, None] + torch.arange(C, device=dev)[None, :]  # (B,C)
    sp = torch.arange(L, device=dev)[None, :].expand(B, L)
    mc = sp < pos0.long()[:, None]
    mc = mc[:, None, :] & (sp[:, None, :] <= qpos[:, :, None])         # (B,C,L)
    i = torch.arange(C, device=dev)
    mx = i[None, :] <= i[:, None]                                       # (C,C)
    mask = torch.cat([mc, mx[None].expand(B, C, C)], dim=2)             # (B,C,L+C)
    kk = torch.cat([cache["k"].to(q.dtype), k.to(q.dtype)], dim=1)
    vv = torch.cat([cache["v"].to(q.dtype), v.to(q.dtype)], dim=1)
    scale = scale if scale is not None else d ** -0.5
    return _mha_chunk(q, kk, vv, mask, scale)


def cache_write_decode(cache, k, v, pos, live=None):
    """Write one token at per-row position ``pos`` (B,).  Rows with
    ``live`` False keep their old slot value (each row writes only its own
    row, so the select needs no device sync)."""
    B, L = cache["k"].shape[:2]
    rows = torch.arange(B, device=k.device)
    slot = pos.long() % L
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        val = new[:, 0].to(c.dtype)
        if live is not None:
            val = torch.where(live[:, None, None], val, c[rows, slot])
        c[rows, slot] = val
    return cache


def cache_valid_mask(cache, pos):
    """(B, L) bool — slots visible to the token at per-row position pos."""
    L = cache["k"].shape[1]
    return torch.arange(L, device=pos.device)[None, :] <= pos.long()[:, None]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((D, F_), ("embed", "mlp")),
        "w_up": ParamSpec((D, F_), ("embed", "mlp")),
        "w_down": ParamSpec((F_, D), ("mlp", "embed")),
    }


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU (or GeGLU) MLP."""
    h = _act(cfg.mlp_activation, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (per-row capacity dispatch)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> dict:
    """The second-to-last dim of every leaf is the one its product contracts
    (D for the router and for gate/up, F for down), so the default fan-in
    rule of ``params.init`` is the contracted size here, as in the
    reference."""
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ParamSpec((D, E), ("embed", "experts_r")),
        "w_gate": ParamSpec((E, D, F_), ("experts", "embed", "moe_mlp")),
        "w_up": ParamSpec((E, D, F_), ("experts", "embed", "moe_mlp")),
        "w_down": ParamSpec((E, F_, D), ("experts", "moe_mlp", "embed")),
    }


def _rank_within_expert(e_flat):
    """Per-row rank of each assignment within its expert, in assignment
    order: (B, T) expert ids -> (B, T) int64 ranks.  A stable sort groups
    equal ids in order, the first index of each id's run is its rank 0,
    and the inverse permutation puts the ranks back."""
    T = e_flat.shape[1]
    e_sorted, order = torch.sort(e_flat, dim=1, stable=True)
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    ranks_sorted = torch.arange(T, device=e_flat.device)[None, :] - first
    return torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)


def moe_slots(idx, cfg: ModelConfig):
    """The dispatch plan of a call: top-K expert ids (B,S,K) -> (slot (B,S*K)
    of each assignment in its row's (E*C) expert slots, E*C where it is
    dropped; the capacity C, per row and expert)."""
    B, S, K = idx.shape
    E = cfg.num_experts
    C = max(1, int(math.ceil(S * K / E * cfg.capacity_factor)))
    e_flat = idx.reshape(B, S * K)
    ranks = _rank_within_expert(e_flat)
    slot = torch.where(ranks < C, e_flat * C + ranks, torch.full_like(ranks, E * C))
    return slot, C


def moe_route(p, x, cfg: ModelConfig):
    """x (B,S,D) -> (renormalised top-K weights, top-K expert ids (B,S,K),
    router probabilities (B,S,E) f32)."""
    # router logits from the unrounded f32 product of the operands
    probs = torch.softmax(x.to(f32) @ p["router"].to(f32), dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-9), idx, probs


def moe_apply(p, x, cfg: ModelConfig):
    """x (B,S,D) -> (y, aux loss).  Per-row (sequence) capacity dispatch: each
    row gives every expert C slots, assignments past them are dropped, every
    expert computes all its slots (empty ones on a zero row), and each token
    gathers its K slots back, weighted by its renormalised top-K."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    w, idx, probs = moe_route(p, x, cfg)                        # (B,S,K)

    # switch-style aux load-balancing loss
    me = probs.mean(dim=(0, 1))                                 # (E,)
    counts = torch.zeros(E, dtype=f32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=f32, device=x.device))
    aux = E * (me * counts / (B * S * K)).sum()

    T = S * K
    slot, C = moe_slots(idx, cfg)
    tok = torch.arange(S, device=x.device).repeat_interleave(K).expand(B, T)
    # the token of every slot, S (the zero sentinel row) where it is empty;
    # dropped assignments land in a spare column that is cut off
    buf_tok = torch.full((B, E * C + 1), S, dtype=torch.long, device=x.device)
    buf_tok.scatter_(1, slot, tok)
    buf_tok = buf_tok[:, : E * C]

    xp = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)            # sentinel row
    xs = torch.gather(xp, 1, buf_tok[:, :, None].expand(B, E * C, D))
    xs = xs.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = _act(cfg.mlp_activation, torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    yexp = torch.bmm(h, p["w_down"]).view(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine by gather: each token pulls its K slots back
    yp = torch.cat([yexp, yexp.new_zeros(B, 1, D)], dim=1)
    gat = torch.gather(yp, 1, slot[:, :, None].expand(B, T, D))  # (B,T,D)
    y = (gat.view(B, S, K, D) * w[..., None].to(gat.dtype)).sum(dim=2)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    d = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                                init="embed", scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return d


def embed_apply(p, tokens, cfg: ModelConfig):
    x = p["embedding"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed_logits(p, x, cfg: ModelConfig):
    """f32 logits: the products are taken in f32 (the reference accumulates
    bf16 inputs into an f32 result)."""
    if cfg.tie_embeddings:
        return x.to(f32) @ p["embedding"].to(f32).t()
    return x.to(f32) @ p["unembed"].to(f32)
