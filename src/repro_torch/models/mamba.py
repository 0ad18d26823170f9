"""Mamba-2 / SSD (state-space duality) layer of the port [arXiv:2405.21060].

A port of the reference's ``models/mamba.py``.  Full-sequence prefill
runs the chunked scan, through the SSD kernel (``kernels/ssd_scan``) when
``use_kernels`` is set, else through :func:`_ssd_scan_chunks`, which keeps
the reference's bf16 rounding points.  Chunked prefill and decode stay
plain tensor code, as in the reference.  States are f32; products take
activation-dtype inputs with f32 accumulation.

Caches are per-row dicts ``{"h", "conv_x", "conv_B", "conv_C"}``.  The
chunk and decode steps update them in place; a row they must leave alone
(``true_len == 0`` in a chunk, ``live`` False in decode) comes out
bit-unchanged.

In a sharded step (``shd`` an ``Spmd``) the heads run tensor-parallel:
each device holds its heads' projections, conv taps, decay, skip, norm
scale and state (the head count is read off the local ``A_log``), and B
and C (one group) whole; the output projection's partial sums are
reduced.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import _proj, mesh_of, noop_shd
from repro_torch.models.params import ParamSpec

f32 = torch.float32


# Random init of A and dt as Mamba-2 draws them: A log-uniform in [1, 16],
# dt_bias such that softplus(dt_bias) is about log-uniform in [1e-3, 1e-1]
# (the bounds are softplus^-1 of those).  The reference starts both at zero
# (A = 1, dt about 0.7): every head then forgets within a few tokens, the
# carry between scan chunks is nil, and a deep random stack amplifies
# rounding chaotically.
A_LOG_BOUNDS = (0.0, math.log(16.0))
DT_BIAS_BOUNDS = (math.log(math.expm1(1e-3)), math.log(math.expm1(1e-1)))


def ssd_specs(cfg: ModelConfig) -> dict:
    """The reference's leaves.  ``fan_in`` is the contracted size (D for the
    input projections, H*P for ``w_out``): the reference's rule takes the
    second-to-last dim, which is G = 1 for ``w_B``/``w_C`` and H or P for
    the others, and gives random full-width weights far too large.
    ``A_log`` and ``dt_bias`` draw as in Mamba-2 (above)."""
    D = cfg.d_model
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    K = cfg.ssm_conv
    return {
        "w_z": ParamSpec((D, H, P), ("embed", "heads", "qkv"), fan_in=D),
        "w_x": ParamSpec((D, H, P), ("embed", "heads", "qkv"), fan_in=D),
        "w_B": ParamSpec((D, G, N), ("embed", "groups", "state"), fan_in=D),
        "w_C": ParamSpec((D, G, N), ("embed", "groups", "state"), fan_in=D),
        "w_dt": ParamSpec((D, H), ("embed", "heads"), fan_in=D),
        "conv_x": ParamSpec((H, P, K), ("heads", "qkv", "conv"), init="normal", scale=0.5),
        "conv_B": ParamSpec((G, N, K), ("groups", "state", "conv"), init="normal", scale=0.5),
        "conv_C": ParamSpec((G, N, K), ("groups", "state", "conv"), init="normal", scale=0.5),
        "A_log": ParamSpec((H,), ("heads",), dtype=f32, init="uniform",
                           bounds=A_LOG_BOUNDS),
        "dt_bias": ParamSpec((H,), ("heads",), dtype=f32, init="uniform",
                             bounds=DT_BIAS_BOUNDS),
        "D_skip": ParamSpec((H,), ("heads",), dtype=f32, init="ones"),
        "norm": {"scale": ParamSpec((H, P), ("heads", "qkv"), dtype=f32, init="zeros")},
        "w_out": ParamSpec((H, P, D), ("heads", "qkv", "embed"), fan_in=H * P),
    }


def ssm_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    K = cfg.ssm_conv
    return {
        "h": ParamSpec((batch, H, P, N), ("batch", "heads", "qkv", "state"), dtype=f32, init="zeros"),
        "conv_x": ParamSpec((batch, K - 1, H, P), ("batch", "conv", "heads", "qkv"), init="zeros"),
        "conv_B": ParamSpec((batch, K - 1, G, N), ("batch", "conv", "groups", "state"), init="zeros"),
        "conv_C": ParamSpec((batch, K - 1, G, N), ("batch", "conv", "groups", "state"), init="zeros"),
    }


def _causal_conv(x, w):
    """Depthwise causal conv along seq.  x: (B,S,...chan), w: (...chan,K)."""
    K = w.shape[-1]
    S = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, *x.shape[2:])), x], dim=1)
    return sum(xp[:, j:j + S] * w[..., j] for j in range(K))


def _conv_step(state, xt, w):
    """state: (B,K-1,...), xt: (B,...) -> (y (B,...), new_state (B,K-1,...))."""
    K = w.shape[-1]
    dt = torch.promote_types(state.dtype, xt.dtype)
    full = torch.cat([state.to(dt), xt[:, None].to(dt)], dim=1)   # (B,K,...)
    y = sum(full[:, j] * w[..., j] for j in range(K))
    return y, full[:, 1:]


def _gated_norm(p_norm, y, z, eps):
    y = y * F.silu(z.to(f32))
    var = (y * y).mean(dim=-1, keepdim=True)          # over P, per head
    y = y * torch.rsqrt(var + eps)
    return y * (p_norm["scale"] + 1.0)


def _project(p, x):
    z = _proj(x, p["w_z"])
    xr = _proj(x, p["w_x"])
    Br = _proj(x, p["w_B"])
    Cr = _proj(x, p["w_C"])
    dt = (x @ p["w_dt"]).to(f32)
    return z, xr, Br, Cr, dt


def _out(p, y):
    """y (B,S,H,P) @ w_out (H,P,D) -> (B,S,D)."""
    H, P, D = p["w_out"].shape
    return y.reshape(*y.shape[:-2], H * P) @ p["w_out"].reshape(H * P, D)


def _reduce_out(out, cfg: ModelConfig, shd):
    """The output projection's partial sums over the heads' axes, reduced
    in a sharded step."""
    sp = mesh_of(shd)
    if sp is None:
        return out
    return sp.reduce(out, sp.tp((cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim),
                                ("embed", "heads", "qkv"), 1))


def _expand_heads(t, H: int):
    """(B,...,G,N) -> (B,...,H,N) repeating each group H//G times."""
    rep = H // t.shape[-2]
    return t.repeat_interleave(rep, dim=-2) if rep > 1 else t


def _ssd_scan_chunks(xc, Bc, Cc, da, dt, h0, H: int, Q: int):
    """Chunked SSD scan over conv-activated projections, with the
    reference's rounding points: M, x*dt, C, h and B*wt are cast to the
    activation dtype before each product, which accumulates in f32.

    xc: (B,S,H,P), Bc/Cc: (B,S,G,N), da/dt: (B,S,H), h0: (B,H,P,N) initial
    state.  S must be a multiple of Q.  Returns (h_last, y (B,S,H,P) f32)."""
    B, S = xc.shape[:2]
    nc = S // Q
    act = xc.dtype
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    h = h0
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xk, Bk, Ck, dak, dtk = xc[:, sl], Bc[:, sl], Cc[:, sl], da[:, sl], dt[:, sl]
        cum = dak.cumsum(dim=1)                                   # (B,Q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]             # (B,q,t,H)
        L = seg.masked_fill(~tri[None, :, :, None], float("-inf")).exp()
        CB = torch.einsum("bqgn,btgn->bqtg", Ck.to(f32), Bk.to(f32))
        M = _expand_heads(CB, H) * L
        xdt = xk.to(f32) * dtk[..., None]
        y_in = torch.einsum("bqth,bthp->bqhp", M.to(act).to(f32),
                            xdt.to(act).to(f32))
        Ch = _expand_heads(Ck, H)                                 # (B,Q,H,N)
        y_off = torch.einsum("bqhn,bhpn->bqhp", Ch.to(act).to(f32),
                             h.to(act).to(f32))
        y_off = y_off * cum.exp()[..., None]
        wt = (cum[:, -1:, :] - cum).exp()                         # (B,Q,H)
        Bh = _expand_heads(Bk, H)
        h = h * cum[:, -1, :].exp()[:, :, None, None] + torch.einsum(
            "bthn,bthp->bhpn", (Bh.to(f32) * wt[..., None]).to(act).to(f32),
            xdt.to(act).to(f32))
        ys.append(y_in + y_off)
    return h, torch.cat(ys, dim=1)


def _rows(B: int, device):
    return torch.arange(B, device=device)[:, None]


def ssd_apply_full(p, x, cfg: ModelConfig, shd=noop_shd, *, want_state: bool = False,
                   true_len=None, use_kernels: bool = False):
    """Full-sequence SSD.  x: (B,S,D) -> (y, fresh cache | None).

    Non-divisible S is front-padded with zeros to a chunk multiple: leading
    zero tokens are exact no-ops for the causal conv and the state.
    ``true_len`` (B,) counts the valid tokens of right-padded rows: pad
    positions get dt=0 and x=0 (exact state no-ops) and the conv tail is
    gathered at each row's last valid positions."""
    B, S_in, D = x.shape
    Q = min(cfg.ssm_chunk, S_in)
    lead = (-S_in) % Q
    if lead:
        x = F.pad(x, (0, 0, lead, 0))
    S = x.shape[1]
    H, P, N = p["A_log"].shape[0], cfg.ssm_headdim, cfg.ssm_state

    z, xr, Br, Cr, dt = _project(p, x)
    xc = F.silu(_causal_conv(xr, p["conv_x"]))
    Bc = F.silu(_causal_conv(Br, p["conv_B"]))
    Cc = F.silu(_causal_conv(Cr, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])                        # (B,S,H) f32
    if true_len is not None:
        seq = torch.arange(S, device=x.device)[None, :] - lead
        valid = seq < true_len.long()[:, None]                # (B,S)
        dt = torch.where(valid[..., None], dt, 0.0)
        xc = torch.where(valid[..., None, None], xc, torch.zeros((), dtype=xc.dtype))
    a = -torch.exp(p["A_log"].to(f32))                        # (H,)
    da = dt * a                                               # (B,S,H) <= 0

    if use_kernels:
        y, h_last = ssd_scan(xc.contiguous(), Bc.contiguous(), Cc.contiguous(),
                             dt.contiguous(), da.contiguous(), chunk=Q)
    else:
        h0 = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
        h_last, y = _ssd_scan_chunks(xc, Bc, Cc, da, dt, h0, H, Q)
    y = y + p["D_skip"][:, None] * xc.to(f32)
    y = _gated_norm(p["norm"], y, z, cfg.norm_eps)
    out = _out(p, shd(y.to(x.dtype), ("batch", "act_seq", "heads", "qkv")))
    if lead:
        out = out[:, lead:]
    out = _reduce_out(out, cfg, shd)
    if not want_state:
        return out, None
    K = cfg.ssm_conv
    if S < K - 1:
        raise ValueError(f"prefill of {S} tokens is shorter than the conv "
                         f"receptive field {K - 1}")
    if true_len is None:
        def tail(t):
            # a copy: a view would keep the whole (B,S,...) projection alive
            # for as long as the cache lives
            return t[:, S - (K - 1):].clone()
    else:
        # per-row last K-1 valid raw projections (pre-conv)
        idx = (lead + true_len.long()[:, None] - (K - 1)
               + torch.arange(K - 1, device=x.device)[None, :]).clamp(min=0)

        def tail(t):
            return t[_rows(B, x.device), idx]
    cache = {"h": h_last,
             "conv_x": tail(xr).to(x.dtype),
             "conv_B": tail(Br).to(x.dtype),
             "conv_C": tail(Cr).to(x.dtype)}
    return out, cache


def ssd_apply_chunk(p, x, cache, cfg: ModelConfig, shd=noop_shd, *, true_len):
    """One chunked-prefill step with carried state, in place.

    x: (B,C,D) right-padded chunk of longer prompts; ``cache`` holds the
    state after the previous chunks; ``true_len`` (B,) counts this chunk's
    valid tokens (0: the row is left bit-unchanged).  Matches
    ``ssd_apply_full`` on the concatenated sequence: the causal conv reads
    the cached last K-1 raw projections.  Returns y (B,C,D)."""
    B, C, D = x.shape
    H = p["A_log"].shape[0]
    K = cfg.ssm_conv
    z, xr, Br, Cr, dt = _project(p, x)
    xcat = torch.cat([cache["conv_x"].to(xr.dtype), xr], dim=1)
    Bcat = torch.cat([cache["conv_B"].to(Br.dtype), Br], dim=1)
    Ccat = torch.cat([cache["conv_C"].to(Cr.dtype), Cr], dim=1)
    xc = F.silu(_causal_conv(xcat, p["conv_x"])[:, K - 1:])
    Bc = F.silu(_causal_conv(Bcat, p["conv_B"])[:, K - 1:])
    Cc = F.silu(_causal_conv(Ccat, p["conv_C"])[:, K - 1:])
    dt = F.softplus(dt + p["dt_bias"])                        # (B,C,H) f32
    valid = torch.arange(C, device=x.device)[None, :] < true_len.long()[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)
    xc = torch.where(valid[..., None, None], xc, torch.zeros((), dtype=xc.dtype))
    a = -torch.exp(p["A_log"].to(f32))
    da = dt * a

    Q = min(cfg.ssm_chunk, C)
    lead = (-C) % Q
    if lead:  # zero front-pad to a chunk multiple: dt=0 / x=0 state no-ops
        def pad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (lead, 0))
        xc, Bc, Cc, da, dt, z = map(pad, (xc, Bc, Cc, da, dt, z))
    h_last, y = _ssd_scan_chunks(xc, Bc, Cc, da, dt, cache["h"].to(f32), H, Q)
    y = y + p["D_skip"][:, None] * xc.to(f32)
    y = _gated_norm(p["norm"], y, z, cfg.norm_eps)
    out = _out(p, shd(y.to(x.dtype), ("batch", "act_seq", "heads", "qkv")))
    if lead:
        out = out[:, lead:]

    # new conv tail: the K-1 raw projections ending at the last valid token,
    # xcat[true_len : true_len + K-1]; true_len == 0 keeps the old tail
    idx = true_len.long()[:, None] + torch.arange(K - 1, device=x.device)[None, :]
    rows = _rows(B, x.device)
    cache["h"].copy_(h_last)
    for n, t in (("conv_x", xcat), ("conv_B", Bcat), ("conv_C", Ccat)):
        cache[n].copy_(t[rows, idx])
    return out


def ssd_apply_decode(p, x, cache, cfg: ModelConfig, shd=noop_shd, *, live=None):
    """One-token recurrent step, in place.  x: (B,1,D) -> y (B,1,D).
    Rows with ``live`` False keep every cache entry bit-unchanged (the
    state update is destructive; the select needs no device sync)."""
    H = p["A_log"].shape[0]
    z, xr, Br, Cr, dt = _project(p, x)
    xt, nconv_x = _conv_step(cache["conv_x"], xr[:, 0], p["conv_x"])
    Bt, nconv_B = _conv_step(cache["conv_B"], Br[:, 0], p["conv_B"])
    Ct, nconv_C = _conv_step(cache["conv_C"], Cr[:, 0], p["conv_C"])
    xt, Bt, Ct = F.silu(xt), F.silu(Bt), F.silu(Ct)
    dt = F.softplus(dt[:, 0] + p["dt_bias"])                  # (B,H)
    a = -torch.exp(p["A_log"].to(f32))
    da = torch.exp(dt * a)                                    # (B,H)
    Bh = _expand_heads(Bt, H).to(f32)                         # (B,H,N)
    Ch = _expand_heads(Ct, H).to(f32)
    xdt = xt.to(f32) * dt[..., None]                          # (B,H,P)
    h = cache["h"] * da[:, :, None, None] + torch.einsum("bhn,bhp->bhpn", Bh, xdt)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + p["D_skip"][:, None] * xt.to(f32)
    y = _gated_norm(p["norm"], y, z[:, 0], cfg.norm_eps)
    out = _out(p, y.to(x.dtype)[:, None])
    for n, new in (("h", h), ("conv_x", nconv_x), ("conv_B", nconv_B),
                   ("conv_C", nconv_C)):
        if n != "h" and cache[n].dtype != x.dtype:
            # the reference returns the conv tails in the activations'
            # dtype, so a bf16 pool's tails widen to f32 under f32 weights
            # at the first decode step; the leaf is replaced to match
            cache[n] = cache[n].to(x.dtype)
        c = cache[n]
        new = new.to(c.dtype)
        if live is not None:
            new = torch.where(live.view(-1, *([1] * (c.dim() - 1))), new, c)
        c.copy_(new)
    return _reduce_out(out, cfg, shd)
