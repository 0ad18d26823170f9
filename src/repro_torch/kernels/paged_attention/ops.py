"""Paged decode attention: the CUDA kernel on GPU tensors, the plain version
on CPU tensors.

``launches`` counts the kernel launches of this wrapper (reset it to 0 to
count a window).  A CUDA tensor never reaches the plain version: it
launches the kernel or raises.  On ``meta`` tensors (the dry run) nothing
launches: the shapes are checked, the output is a meta tensor and
:func:`work` goes to ``kernels.meta``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

launches = 0
TOKENS_PER_SPLIT = 64    # csrc/paged_attention.cu: kSplitTok
HEADS_PER_BLOCK = 8      # csrc/paged_attention.cu: kRep
# (device, counters, partial floats) -> one f32 allocation: int32 counters
# (0 between calls: each call leaves the ones it takes at 0), then the
# splits' partial (max, sum) pairs and accumulators
_scratch: dict[tuple, torch.Tensor] = {}


def work(B, H, KV, d, max_blk, ctx, itemsize):
    """(bytes, flops) of one call over live contexts ``ctx`` (one per row):
    q read and the output written once, every live token's k and v read
    once, the block table and the lengths read; two products of 2 d flops
    for every live token of every head."""
    toks = sum(ctx)
    nbytes = (2 * B * H * d * itemsize + 2 * toks * KV * d * itemsize
              + B * max_blk * 4 + B * 4)
    return nbytes, 4.0 * toks * H * d


def _scratch_ptrs(device, n_cnt: int, n_ml: int, n_acc: int) -> tuple[int, int, int]:
    key = (device, n_cnt, n_ml, n_acc)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.zeros(-(-n_cnt // 4) * 4 + n_ml + n_acc, dtype=torch.float32,
                          device=device)
        _scratch[key] = buf
    base = buf.data_ptr()
    ml = base + 4 * (-(-n_cnt // 4) * 4)
    return base, ml, ml + 4 * n_ml


def paged_decode_attention(q, k_pages, v_pages, block_table, context_len, *,
                           scale: float | None = None):
    """q (B,H,d); pools (num_blocks, bs, KV, d); block_table (B, max_blk)
    int32, -1 = unmapped; context_len (B,) int32 -> (B,H,d) in q.dtype.

    On the GPU: one launch, d <= 256 with rows of a multiple of 16 bytes
    (d % 8 in bf16, d % 4 in f32) and 16-byte aligned pools.  Calls that
    share a device must not run concurrently on two streams: they share the
    scratch of their shape."""
    global launches
    tensors = (q, k_pages, v_pages, block_table, context_len)
    build.refuse_autograd("paged_decode_attention", tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   context_len, scale=scale)
    dev = q.device
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on one "
                         f"CUDA (or meta) device, got {[str(t.device) for t in tensors]}")
    B, H, d = q.shape
    nb, bs, KV, d2 = k_pages.shape
    max_blk = block_table.shape[1]
    if v_pages.shape != k_pages.shape or d2 != d or H % KV \
            or block_table.shape != (B, max_blk) or context_len.shape != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}, block_table "
                         f"{tuple(block_table.shape)}, context_len "
                         f"{tuple(context_len.shape)}")
    if block_table.dtype != torch.int32 or context_len.dtype != torch.int32:
        raise TypeError("block_table and context_len must be int32")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError("k and v pools must share a dtype")
    kv_code = build.dtype_code(k_pages)
    if d > 256 or d * k_pages.element_size() % 16 \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"paged_decode_attention: head_dim {d} must be <= 256 "
                         "with 16-byte rows, and the pools 16-byte aligned")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention takes contiguous tensors")
    if dev.type == "meta":
        # the lengths have no values here: count every row's table full
        meta.report("paged_attention", *work(B, H, KV, d, max_blk, [max_blk * bs] * B,
                                             k_pages.element_size()))
        return torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    n_split = max(1, -(-max_blk * bs // TOKENS_PER_SPLIT))
    n_rows = B * KV * -(-(H // KV) // HEADS_PER_BLOCK)    # (row, kv head group)s
    n_part = n_rows * n_split * HEADS_PER_BLOCK
    cnt, ml, acc = _scratch_ptrs(dev, n_rows, 2 * n_part, d * n_part)
    out = torch.empty_like(q)
    rc = build.launcher("paged_attention")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), context_len.data_ptr(), out.data_ptr(),
        cnt, ml, acc, B, H, KV, d, bs, max_blk, n_split, float(scale),
        build.dtype_code(q), kv_code, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_attention")
    launches += 1
    return out
