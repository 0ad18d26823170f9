"""Paged decode attention: the CUDA kernel on GPU tensors, the plain version
on CPU tensors.

``launches`` counts the kernel launches of this wrapper (reset it to 0 to
count a window).  A CUDA tensor never reaches the plain version: it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

launches = 0
TOKENS_PER_SPLIT = 64


def paged_decode_attention(q, k_pages, v_pages, block_table, context_len, *,
                           scale: float | None = None):
    """q (B,H,d); pools (num_blocks, bs, KV, d); block_table (B, max_blk)
    int32, -1 = unmapped; context_len (B,) int32 -> (B,H,d) in q.dtype."""
    global launches
    tensors = (q, k_pages, v_pages, block_table, context_len)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   context_len, scale=scale)
    if not all(t.device == q.device and t.device.type == "cuda" for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    B, H, d = q.shape
    nb, bs, KV, d2 = k_pages.shape
    if v_pages.shape != k_pages.shape or d2 != d or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or context_len.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"context_len {tuple(context_len.shape)} for B={B}")
    if block_table.dtype != torch.int32 or context_len.dtype != torch.int32:
        raise TypeError("block_table and context_len must be int32")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError("k and v pools must share a dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention takes contiguous tensors")
    scale = d ** -0.5 if scale is None else scale
    max_blk = block_table.shape[1]
    # each split block walks about TOKENS_PER_SPLIT tokens of a row
    pps = max(1, TOKENS_PER_SPLIT // bs)
    n_split = max(1, -(-max_blk // pps))
    rep = H // KV
    out = torch.empty_like(q)
    part_ml = torch.empty((B, KV, n_split, rep, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, KV, n_split, rep, d), dtype=torch.float32, device=q.device)
    fn = build.launcher("paged_attention")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), context_len.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(),
            B, H, KV, d, bs, max_blk, pps, n_split, float(scale),
            build.dtype_code(q), build.dtype_code(k_pages),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    launches += 1
    return out
