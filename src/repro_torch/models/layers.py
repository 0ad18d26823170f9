"""Functional layers of the port: the reference's ``models/layers.py``, for
dense GQA decoders (qwen2, gemma), MoE decoders with q/k RMSNorm
(qwen3-moe), windowed decoders with ring KV caches (gemma3, mixtral), a
vision prefix under a prefix-LM mask (paligemma), the hybrid stack (jamba)
and the encoder-decoder (whisper: LayerNorm, a biased GELU MLP,
cross-attention); for training, the chunked cross-entropy and
rematerialisation.

Conventions follow the reference: activations in the parameter dtype,
softmax and norm statistics in f32, attention scores accumulated in f32
(``preferred_element_type=f32`` there), layouts (B, S, heads, head_dim).
KV caches are dicts of tensors that the cache writers update in place;
every write that the reference drops (``mode="drop"`` or a select against
the old cache) is masked here, so the entries it leaves alone stay
bit-identical.

``shd(x, names)`` is the reference's sharding hook, called at its sites
with its logical names: the identity on one card (:func:`noop_shd`), a
``distributed.spmd.Spmd`` in a sharded step, whose code runs on each
device's shards (:func:`mesh_of`; the attention regions ``head_axes``,
``reduce``, ``kv_for_queries``, ``cache_to_mesh`` and ``attend_decode``
take the ``Spmd`` or None, and on one card are the identity or the
one-card code).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

f32 = torch.float32
NEG = -1e30
UNEMBED_ROWS = 32768      # vocabulary entries per f32 slice of the table
KV_NAMES = ("batch", "act_kv", "kv_heads", "qkv")
RESIDUAL = ("batch", "act_seq", "embed")


def noop_shd(x, names):
    """The sharding hook on one card: the identity."""
    return x


def mesh_of(shd):
    """The ``Spmd`` of a sharded step, None on one card."""
    return shd if getattr(shd, "is_mesh", False) else None


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


def layernorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("norm",), dtype=f32, init="ones"),
            "bias": ParamSpec((d,), ("norm",), dtype=f32, init="zeros")}


def layernorm(p, x, eps: float):
    """LayerNorm with the biased variance, in f32, cast back to x's dtype."""
    xf = x.to(f32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


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

def attention_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """q/k/v/o projections; ``cross`` (an encoder-decoder's cross-attention,
    keys and values from the encoder's output) takes no biases."""
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
    if cfg.attn_bias and not cross:
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

    q: (B,cq,H,d)  k,v: (B,sk,KV,d)  mask: (B or 1, cq, sk) bool or None.
    Without autograd the f32 scores are updated in place, so one (B, heads,
    cq, sk) tensor of them is alive at a time (serving).  Under autograd
    (grad enabled and an input that requires grad) every step is out of
    place: ``exp``'s output is what its backward reads, and an in-place
    division would overwrite it.  Both forms compute the same numbers."""
    B, cq, H, d = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, cq, KV, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(f32), k.to(f32))
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG).to(f32)[:, None, None]   # (B|1,1,1,cq,sk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        scores = scores * scale
        if bias is not None:
            scores = scores + bias
        m = scores.amax(dim=-1, keepdim=True).clamp(min=-1e29)   # guard masked rows
        e = (scores - m).exp()
        w = (e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)).to(v.dtype)
    else:
        scores.mul_(scale)
        if bias is not None:
            scores.add_(bias)
        m = scores.amax(dim=-1, keepdim=True).clamp(min=-1e29)
        e = scores.sub_(m).exp_()
        s = e.sum(dim=-1, keepdim=True)
        w = e.div_(s.clamp(min=1e-30)).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(B, cq, H, d)


def attention_full(q, k, v, *, causal: bool, window: int = 0,
                   prefix_len: int = 0, scale: float | None = None,
                   q_chunk: int = 512):
    """Attention over full sequences (prefill), the queries in slices of
    ``q_chunk``, each slice one masked :func:`_mha_chunk` over every key:
    a query row's softmax is its own, so the slicing changes no number and
    bounds the f32 scores to (B, heads, q_chunk, Skv).  The first
    ``prefix_len`` positions (a vision prefix) see each other both ways:
    the prefix-LM mask.

    q: (B,Sq,H,d); k,v: (B,Skv,KV,d), q positions == kv positions."""
    Sq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        mask = None
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            mask = kpos <= qpos
            if window:
                mask &= kpos > qpos - window
            if prefix_len:
                mask |= (qpos < prefix_len) & (kpos < prefix_len)
            mask = mask[None]
        outs.append(_mha_chunk(q[:, q0:q1], k, v, mask, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention_decode(q, k_cache, v_cache, kv_mask, scale: float | None = None, *,
                     sp=None, seq_axes=()):
    """Single-step decode attention.

    q: (B,1,H,d); caches: (B,S,KV,d); kv_mask: (B,S) bool valid slots.  In
    a sharded step (``sp``) over a cache whose slots are split over
    ``seq_axes``, the row maxima, the sums of the exponentials and the
    weighted values (partial sums over the slots) are all-reduced."""
    B, _, H, d = q.shape
    KV = k_cache.shape[2]
    rep = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, KV, rep, d)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg.to(f32), k_cache.to(f32)) * scale
    scores = torch.where(kv_mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG))
    m = scores.amax(dim=-1, keepdim=True)
    if sp is not None:
        m = sp.all_reduce(m, "max", seq_axes)
    m = m.clamp(min=-1e29)
    e = torch.exp(scores - m)
    s = e.sum(-1, keepdim=True)
    if sp is not None:
        s = sp.all_reduce(s, "sum", seq_axes)
    w = (e / s.clamp(min=1e-30)).to(v_cache.dtype)
    del s     # not alive in the product below: the dry run counts its bytes
    out = torch.einsum("bgrs,bsgd->bgrd", w, v_cache)
    if sp is not None:
        out = sp.all_reduce(out, "sum", seq_axes)
    return out.reshape(B, 1, H, d)


def attn_out(p, ctx):
    """ctx (B,S,H,hd) @ wo (H,hd,D) -> (B,S,D)."""
    H, hd, D = p["wo"].shape
    return ctx.reshape(*ctx.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, D)


# ---------------------------------------------------------------------------
# KV caches: global (slot == absolute position) and ring (windowed layers)
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: ModelConfig, batch: int, length: int, *,
                   ring: bool = False, heads: int = 0) -> dict:
    """``heads``: the KV heads a device holds, where not all of them."""
    KV, hd = heads or cfg.num_kv_heads, cfg.head_dim
    axes = ("batch", "act_kv", "kv_heads", "qkv")
    d = {"k": ParamSpec((batch, length, KV, hd), axes, init="zeros"),
         "v": ParamSpec((batch, length, KV, hd), axes, init="zeros")}
    if ring:
        # absolute position held in each ring slot (-1 = empty)
        d["pos"] = ParamSpec((batch, length), ("batch", "act_kv"),
                             dtype=torch.int32, init="const", scale=-1)
    return d


def ring_write_slots(pos0, n_valid, chunk: int, length: int):
    """Where a chunk of positions pos0 .. pos0+n_valid-1 lands in a ring of
    ``length`` slots: for each slot s, the latest chunk position p = s (mod
    length), whether it is in the chunk, and its index in the chunk, each
    (B, length).  Where the chunk is longer than the ring, the latest
    position that maps to a slot wins, as sequential decode writes would.
    No device sync."""
    p0 = pos0.long()[:, None]
    end1 = p0 + n_valid.long()[:, None] - 1                # last valid position
    s = torch.arange(length, device=pos0.device)[None, :]
    p = end1 - torch.remainder(end1 - s, length)
    valid = (p >= p0) & (n_valid[:, None] > 0)
    return p, valid, (p - p0).clamp(0, chunk - 1)


def cache_write_prefill(cache, k, v, *, ring: bool = False, true_len=None):
    """Write a full prefill's k/v, positions 0..S-1, into a fresh cache.

    Global caches (length may exceed S): right-padded rows need no mask, pad
    slots sit at positions >= true_len and decode overwrites slot p when
    position p becomes visible.  Ring caches hold each row's last W valid
    tokens (W the ring's length) in slots p % W and mark pad slots -1;
    ``true_len`` (B,) counts the valid tokens of right-padded rows."""
    B, S = k.shape[:2]
    if ring:
        n = (torch.full((B,), S, device=k.device) if true_len is None
             else true_len)
        return cache_write_chunk(cache, k, v, torch.zeros_like(n), n, ring=True)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cache


def chunk_write_slots(pos0, n_valid, chunk: int):
    """(flat chunk index, row, slot) of the valid positions of a chunk write
    into a global cache; one device sync, computed once per forward pass."""
    ar = torch.arange(chunk, device=pos0.device)[None, :]
    sel = (ar < n_valid[:, None]).reshape(-1).nonzero()[:, 0]
    rows = sel // chunk
    return sel, rows, pos0.long()[rows] + sel % chunk


def cache_write_chunk(cache, k, v, pos0, n_valid, *, ring: bool = False,
                      slots=None):
    """Append a chunk of C tokens at per-row positions pos0 .. pos0+n_valid-1.

    k/v: (B,C,KV,hd) right-padded chunk projections; pos0/n_valid (B,).
    Pad positions and rows with n_valid == 0 are not written.  ``slots``:
    precomputed ``chunk_write_slots`` (global) or ``ring_write_slots``
    (ring), which depend only on the cache's length."""
    if ring:
        p, valid, j = slots if slots is not None else ring_write_slots(
            pos0, n_valid, k.shape[1], cache["k"].shape[1])
        idx = j[:, :, None, None].expand(-1, -1, *k.shape[2:])
        m = valid[:, :, None, None]
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c.copy_(torch.where(m, torch.gather(new, 1, idx).to(c.dtype), c))
        cache["pos"].copy_(torch.where(valid, p.to(cache["pos"].dtype), cache["pos"]))
        return cache
    if slots is None:
        slots = chunk_write_slots(pos0, n_valid, k.shape[1])
    sel, rows, pos = slots
    cache["k"][rows, pos] = k.reshape(-1, *k.shape[2:])[sel].to(cache["k"].dtype)
    cache["v"][rows, pos] = v.reshape(-1, *v.shape[2:])[sel].to(cache["v"].dtype)
    return cache


def attention_chunk(q, k, v, cache, pos0, *, window: int = 0, ring: bool = False,
                    scale: float | None = None, q_chunk: int = 512):
    """Chunked-prefill attention: queries at positions pos0+i attend the
    cache as written by previous chunks (positions < pos0) plus this chunk's
    own k/v causally.  ``cache`` is the cache *before* this chunk's write:
    sourcing the chunk from k/v keeps ring layers exact where the chunk is
    longer than the ring.  Queries go in slices of ``q_chunk``, as in
    :func:`attention_full`."""
    B, C, H, d = q.shape
    L = cache["k"].shape[1]
    dev = q.device
    p0 = pos0.long()[:, None]
    qpos = p0 + torch.arange(C, device=dev)[None, :]                  # (B,C)
    if ring:
        sp = cache["pos"].long()                                       # (B,L)
        mc = (sp >= 0) & (sp < p0)
    else:
        sp = torch.arange(L, device=dev)[None, :].expand(B, L)
        mc = sp < p0
    i = torch.arange(C, device=dev)
    kk = torch.cat([cache["k"].to(q.dtype), k.to(q.dtype)], dim=1)
    vv = torch.cat([cache["v"].to(q.dtype), v.to(q.dtype)], dim=1)
    scale = scale if scale is not None else d ** -0.5
    outs = []
    for q0 in range(0, C, q_chunk):
        q1 = min(q0 + q_chunk, C)
        qp = qpos[:, q0:q1, None]
        m_c = mc[:, None, :] & (sp[:, None, :] <= qp)                 # (B,c,L)
        ii = i[q0:q1, None]
        m_x = i[None, :] <= ii                                         # (c,C)
        if window:
            m_c &= sp[:, None, :] > qp - window
            m_x &= i[None, :] > ii - window
        mask = torch.cat([m_c, m_x[None].expand(B, q1 - q0, C)], dim=2)
        outs.append(_mha_chunk(q[:, q0:q1], kk, vv, mask, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def cache_write_decode(cache, k, v, pos, live=None, *, ring: bool = False,
                       length: int = 0, offset: int = 0):
    """Write one token at per-row position ``pos`` (B,), in slot pos % L
    (ring caches record the position too).  Rows with ``live`` False keep
    their old slot values (each row writes only its own row, so the select
    needs no device sync).  A device's part of a cache split along its
    slots holds slots ``offset ..`` of ``length`` in all: a row writes
    only where its slot is one of them."""
    B, L = cache["k"].shape[:2]
    rows = torch.arange(B, device=k.device)
    if length:
        slot = pos.long() % length - offset
        mine = (slot >= 0) & (slot < L)
        live = mine if live is None else live & mine
        slot = slot.clamp(0, L - 1)
    else:
        slot = pos.long() % L
    new = {"k": k[:, 0], "v": v[:, 0]}
    if ring:
        new["pos"] = pos
    for name, val in new.items():
        c = cache[name]
        val = val.to(c.dtype)
        if live is not None:
            keep = live.view(-1, *[1] * (val.dim() - 1))
            val = torch.where(keep, val, c[rows, slot])
        c[rows, slot] = val
    return cache


def cache_valid_mask(cache, pos, *, ring: bool = False, window: int = 0,
                     offset: int = 0):
    """(B, L) bool — slots visible to the token at per-row position pos;
    ``offset``: the first slot of a device's part of a split cache."""
    p = pos.long()[:, None]
    if ring:
        sp = cache["pos"]
        m = (sp >= 0) & (sp <= p)
        if window:
            m &= sp > p - window
        return m
    L = cache["k"].shape[1]
    slots = torch.arange(L, device=pos.device)
    if offset:
        slots = slots + offset
    return slots[None, :] <= p


# ---------------------------------------------------------------------------
# attention regions of a sharded step (``sp`` an ``Spmd``; None on one card,
# where each is the identity or the one-card code)
# ---------------------------------------------------------------------------

def head_axes(sp, cfg: ModelConfig) -> tuple:
    """(query-head axes, KV-head axes) the projections run
    tensor-parallel over."""
    if sp is None:
        return (), ()
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return (sp.tp((D, H, hd), ("embed", "heads", "qkv"), 1),
            sp.tp((D, KV, hd), ("embed", "kv_heads", "qkv"), 1))


def reduce(sp, y, axes):
    """A row-parallel product's partial sums over ``axes``, summed across
    the devices (``Spmd.reduce``)."""
    return y if sp is None else sp.reduce(y, axes)


def kv_for_queries(sp, cfg: ModelConfig, k, v, h_axes, k_axes):
    """k, v cut to the KV heads this device's query heads read."""
    if sp is None:
        return k, v
    H, KV = cfg.num_heads, cfg.num_kv_heads
    return (sp.kv_heads_for(k, H, KV, h_axes, k_axes),
            sp.kv_heads_for(v, H, KV, h_axes, k_axes))


def cache_to_mesh(sp, cfg: ModelConfig, cache, length: int, k_axes):
    """A fresh cache of ``length`` global slots, written whole on this
    device with the KV heads of ``k_axes``, cut to the rules' layout
    (``KV_NAMES``) where this device holds a dim whole: the slots (and a
    ring's positions) and, if the projection left them whole, the KV
    heads.  A dim the projection already split keeps its split (moving it
    onto the slots would take an all-to-all)."""
    if sp is None:
        return cache
    tgt = sp.axes((sp.batch, length, cfg.num_kv_heads, cfg.head_dim), KV_NAMES)
    seq = tgt[1] if not set(tgt[1]) & set(k_axes) else ()
    heads = tgt[2] if not k_axes and not set(tgt[2]) & set(seq) else ()
    out = {}
    for name, t in cache.items():
        t = sp.narrow(t, 1, seq)
        if name != "pos":
            t = sp.narrow(t, 2, heads)
        out[name] = t
    return out


def attend_decode(sp, cfg: ModelConfig, q, k, v, cache, pos, *, length: int,
                  h_axes, k_axes, ring: bool = False, window: int = 0,
                  live=None, write: bool = True):
    """One decode token's attention against its cache (in place): the
    token's k/v written at ``pos``, then the visible slots attended.
    ``write`` False: a cache read only (whisper's cross-KV, every slot
    valid; sharded steps only).

    In a sharded step the cache is this device's part of ``length`` global
    slots, laid out by the rules.  The token's k/v are moved to the
    cache's KV-head layout and written where its slot is this device's;
    queries whose heads are split over an axis that also splits the slots
    are gathered over it, attend every head over the local slots, the
    softmax merges across the slots' axes, and each device keeps its own
    heads."""
    if sp is None:
        cache_write_decode(cache, k, v, pos, live=live, ring=ring)
        mask = cache_valid_mask(cache, pos, ring=ring, window=window)
        return attention_decode(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
    tgt = sp.axes((sp.batch, length, cfg.num_kv_heads, cfg.head_dim), KV_NAMES)
    s_axes, c_axes = tgt[1], tgt[2]
    off, _ = sp.part(length, s_axes)
    if write:
        cache_write_decode(cache, sp.relayout(k, 2, k_axes, c_axes),
                           sp.relayout(v, 2, k_axes, c_axes),
                           pos, live=live, ring=ring, length=length, offset=off)
        mask = cache_valid_mask(cache, pos, ring=ring, window=window, offset=off)
    else:
        mask = torch.ones(cache["k"].shape[:2], dtype=torch.bool, device=q.device)
    G = tuple(a for a in s_axes if a in h_axes)
    if G:
        q = sp.all_gather(q, 2, G)
    rest = tuple(a for a in h_axes if a not in G)
    kk = sp.kv_heads_for(cache["k"], cfg.num_heads, cfg.num_kv_heads, rest, c_axes)
    vv = sp.kv_heads_for(cache["v"], cfg.num_heads, cfg.num_kv_heads, rest, c_axes)
    ctx = attention_decode(q, kk.to(q.dtype), vv.to(q.dtype), mask, sp=sp,
                           seq_axes=s_axes)
    return sp.narrow(ctx, 2, G) if G else ctx


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.mlp_activation == "gelu_plain":
        return {"w_in": ParamSpec((D, F_), ("embed", "mlp")),
                "b_in": ParamSpec((F_,), ("mlp",), init="zeros"),
                "w_out": ParamSpec((F_, D), ("mlp", "embed")),
                "b_out": ParamSpec((D,), ("embed",), init="zeros")}
    return {
        "w_gate": ParamSpec((D, F_), ("embed", "mlp")),
        "w_up": ParamSpec((D, F_), ("embed", "mlp")),
        "w_down": ParamSpec((F_, D), ("mlp", "embed")),
    }


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ModelConfig, shd=noop_shd):
    """SwiGLU or GeGLU MLP; ``gelu_plain``: x @ w_in + b_in, tanh GELU, then
    @ w_out + b_out (whisper).  In a sharded step the hidden width runs
    tensor-parallel: the down product's partial sums are reduced (and
    ``b_out`` added once, after)."""
    sp = mesh_of(shd)
    names = ("batch", "act_seq", "mlp")
    if cfg.mlp_activation == "gelu_plain":
        h = shd(_act("gelu", x @ p["w_in"] + p["b_in"].to(x.dtype)), names)
        if sp is None:
            return h @ p["w_out"] + p["b_out"].to(x.dtype)
        y = sp.reduce(h @ p["w_out"], sp.tp((cfg.d_model, cfg.d_ff), ("embed", "mlp"), 1))
        return y + p["b_out"].to(x.dtype)
    h = shd(_act(cfg.mlp_activation, x @ p["w_gate"]) * (x @ p["w_up"]), names)
    if sp is None:
        return h @ p["w_down"]
    return sp.reduce(h @ p["w_down"], sp.tp((cfg.d_model, cfg.d_ff), ("embed", "mlp"), 1))


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


def moe_apply(p, x, cfg: ModelConfig, shd=noop_shd):
    """x (B,S,D) -> (y, aux loss).  Per-row (sequence) capacity dispatch: each
    row gives every expert C slots, assignments past them are dropped, every
    expert computes all its slots (empty ones on a zero row), and each token
    gathers its K slots back, weighted by its renormalised top-K.

    In a sharded step the routing and the dispatch plan are each row's own
    (capacity counts per row, so a device's rows plan as they would in the
    whole batch); a device computes the slots of its experts (``experts``)
    on its part of their hidden width (``moe_mlp``), each token gathers
    the slots it finds there (the others read the zero row), and the
    partial sums are reduced.  ``aux`` then covers the device's rows."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    sp = mesh_of(shd)
    e0, El, red = 0, E, ()
    if sp is not None:
        shape, names = (E, D, cfg.moe_d_ff), ("experts", "embed", "moe_mlp")
        e_axes = sp.tp(shape, names, 0)
        e0, El = sp.part(E, e_axes)
        red = e_axes + sp.tp(shape, names, 2)
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

    if sp is not None:    # this device's experts' slots
        buf_tok = buf_tok[:, e0 * C:(e0 + El) * C]

    xp = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)            # sentinel row
    xs = torch.gather(xp, 1, buf_tok[:, :, None].expand(B, El * C, D))
    xs = shd(xs.view(B, El, C, D), ("batch", "experts", None, None))
    xs = xs.transpose(0, 1).reshape(El, B * C, D)
    h = _act(cfg.mlp_activation, torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    # the port's expert-major layout: (experts, batch x capacity, moe_mlp)
    h = shd(h, ("experts", None, "moe_mlp"))
    yexp = torch.bmm(h, p["w_down"]).view(El, B, C, D).transpose(0, 1).reshape(B, El * C, D)

    # combine by gather: each token pulls its K slots back
    if sp is not None:    # slots of other devices' experts read the zero row
        local = slot - e0 * C
        slot = torch.where((local >= 0) & (local < El * C), local,
                           torch.full_like(local, El * C))
    yp = torch.cat([yexp, yexp.new_zeros(B, 1, D)], dim=1)
    gat = torch.gather(yp, 1, slot[:, :, None].expand(B, T, D))  # (B,T,D)
    y = (gat.view(B, S, K, D) * w[..., None].to(gat.dtype)).sum(dim=2)
    if sp is not None:
        y = sp.reduce(y, red)
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


def embed_apply(p, tokens, cfg: ModelConfig, shd=noop_shd):
    """Token embeddings.  In a sharded step over a vocabulary split on
    ``model``, each device looks up the tokens its rows of the table hold
    (zero elsewhere) and the parts are reduced: exactly one is non-zero."""
    sp = mesh_of(shd)
    axes = ()
    if sp is not None:
        p = sp.weights(p, embed_specs(cfg))
        axes = sp.tp((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), 0)
    if axes:
        v0, n = sp.part(cfg.vocab_size, axes)
        local = tokens.long() - v0
        mine = (local >= 0) & (local < n)
        x = p["embedding"][local.clamp(0, n - 1)]
        x = sp.reduce(torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype)),
                      axes)
    else:
        x = p["embedding"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed_logits(p, x, cfg: ModelConfig, *, rows: int = UNEMBED_ROWS,
                   shd=noop_shd):
    """f32 logits: the products are taken in f32 (the reference accumulates
    bf16 inputs into an f32 result).  The table is cast to f32 ``rows``
    vocabulary entries at a time, so the f32 copy never holds the whole
    table; every logit is the same product.  In a sharded step each device
    takes the logits of its part of the vocabulary and they are gathered
    whole."""
    xf = x.to(f32)
    sp = mesh_of(shd)
    if sp is not None:
        p = sp.weights(p, embed_specs(cfg))
    if cfg.tie_embeddings:
        w = p["embedding"]
        logits = torch.cat([xf @ w[v0:v0 + rows].to(f32).t()
                            for v0 in range(0, w.shape[0], rows)], dim=-1)
    else:
        w = p["unembed"]
        logits = torch.cat([xf @ w[:, v0:v0 + rows].to(f32)
                            for v0 in range(0, w.shape[1], rows)], dim=-1)
    if sp is None:
        return logits
    return sp.all_gather(logits, logits.dim() - 1,
                         sp.tp((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), 0))


# ---------------------------------------------------------------------------
# training: loss and rematerialisation
# ---------------------------------------------------------------------------

def chunked_xent(p, x, labels, cfg: ModelConfig, shd=noop_shd, *, chunk: int = 512):
    """Cross-entropy without materialising (B,S,V) logits: a loop over
    sequence chunks, each recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so one
    chunk's f32 logits are alive at a time.  S is padded to a whole number
    of chunks with label -1, as the reference pads, so every chunk has one
    shape.  x: (B,S,D) final hidden; labels: (B,S), -1 = ignored.  Returns
    (sum of the nll over valid labels, f32; the count of valid labels)."""
    B, S, D = x.shape
    c = min(chunk, S)
    pad = -S % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)

    def body(xc, lc):
        logits = shd(unembed_logits(p, xc, cfg),                  # (B,c,V) f32
                     ("xent_batch", None, "vocab"))
        lse = torch.logsumexp(logits, dim=-1)
        lbl = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
        valid = lc >= 0
        return torch.where(valid, lse - lbl, 0.0).sum(), valid.sum()

    tot = torch.zeros((), dtype=f32, device=x.device)
    cnt = torch.zeros((), dtype=torch.long, device=x.device)
    for s0 in range(0, S + pad, c):
        nll, n = checkpoint(body, x[:, s0:s0 + c], labels[:, s0:s0 + c],
                            use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot, cnt


REMAT_MODES = ("none", "full", "dots")
# products without batch dims: the reference's
# ``dots_with_no_batch_dims_saveable`` keeps exactly these
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(mode: str, fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass:
    ``"full"`` keeps only the inputs, ``"dots"`` also the outputs of the
    products without batch dims, ``"none"`` runs ``fn`` as it is.  Every
    mode computes the same numbers."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r}: expected one of {REMAT_MODES}")
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)
