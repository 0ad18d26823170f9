"""Plain PyTorch version of the paged decode-attention kernel."""
from __future__ import annotations

import torch

f32 = torch.float32


def paged_attention_ref(q, k_pages, v_pages, block_table, context_len, *,
                        scale: float | None = None):
    """q: (B,H,d); pools (num_blocks, bs, KV, d); block_table (B, max_blk)
    int32 (-1 = unused); context_len (B,) valid positions.  -> (B,H,d)."""
    B, H, d = q.shape
    nb, bs, KV, _ = k_pages.shape
    max_blk = block_table.shape[1]
    rep = H // KV
    scale = d ** -0.5 if scale is None else scale

    bt = block_table.long().clamp(min=0)
    k = k_pages[bt].reshape(B, max_blk * bs, KV, d)      # (B,S,KV,d)
    v = v_pages[bt].reshape(B, max_blk * bs, KV, d)
    kx = k.repeat_interleave(rep, dim=2)
    vx = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.to(f32), kx.to(f32)) * scale
    pos = torch.arange(max_blk * bs, device=q.device)[None, :]
    valid = (pos < context_len.long()[:, None]) & \
        (block_table >= 0).repeat_interleave(bs, dim=1)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    e = torch.exp(s - m)
    w = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhs,bshd->bhd", w, vx.to(f32)).to(q.dtype)
