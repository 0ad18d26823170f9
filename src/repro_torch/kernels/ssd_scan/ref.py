"""Plain PyTorch version of the SSD chunked-scan kernel.

The Mamba-2 state-space-dual recurrence over pre-activated inputs,
  h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T          (per head)
  y_t = C_t h_t
chunked like the reference's ``ssd_scan_ref``, in f32 throughout.  B and C
come unexpanded, (b, S, G, N): head h reads group h // (H // G).
"""
from __future__ import annotations

import torch

f32 = torch.float32


def ssd_scan_ref(x, B, C, dt, da, *, chunk: int):
    """x (b,S,H,P); B,C (b,S,G,N) with H % G == 0; dt,da (b,S,H).
    Returns (y (b,S,H,P) f32, h_last (b,H,P,N) f32)."""
    b, S, H, P = x.shape
    G, N = B.shape[-2:]
    R = H // G
    Q = chunk
    if S % Q or H % G:
        raise ValueError(f"S={S} not a multiple of chunk {Q}, or H={H} % G={G}")
    nc = S // Q
    xdt = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, Q, G, R, P)
    Bq = B.to(f32).reshape(b, nc, Q, G, N)
    Cq = C.to(f32).reshape(b, nc, Q, G, N)
    cum = da.to(f32).reshape(b, nc, Q, G, R).cumsum(dim=2)
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((b, G, R, P, N), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        cm = cum[:, c]                                        # (b,Q,G,R)
        seg = cm[:, :, None] - cm[:, None, :]                 # (b,q,t,G,R)
        # masked before exp: above the diagonal cum_q - cum_t can overflow
        L = seg.masked_fill(above[None, :, :, None, None], float("-inf")).exp()
        CB = torch.einsum("bqgn,btgn->bqtg", Cq[:, c], Bq[:, c])
        y_in = torch.einsum("bqtgr,btgrp->bqgrp", CB[..., None] * L, xdt[:, c])
        y_off = torch.einsum("bqgn,bgrpn->bqgrp", Cq[:, c], h) * cm.exp()[..., None]
        wt = (cm[:, -1:] - cm).exp()                          # (b,Q,G,R)
        h = h * cm[:, -1].exp()[..., None, None] + torch.einsum(
            "btgn,btgrp->bgrpn", Bq[:, c], xdt[:, c] * wt[..., None])
        ys.append(y_in + y_off)
    y = torch.stack(ys, dim=1).reshape(b, S, H, P)
    return y, h.reshape(b, H, P, N)
