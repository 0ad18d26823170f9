"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

import torch

f32 = torch.float32


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B,H,Sq,d); k,v: (B,KV,Skv,d).  Returns (B,H,Sq,d) in q.dtype."""
    B, H, Sq, d = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    scale = d ** -0.5 if scale is None else scale
    kx = k.repeat_interleave(rep, dim=1)
    vx = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), kx.to(f32)) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)  # right-aligned
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    e = torch.exp(s - m)
    w = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(vx.dtype), vx).to(q.dtype)
