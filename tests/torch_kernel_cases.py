"""Shapes and inputs shared by the kernel tests of the PyTorch port (CPU
parity in test_torch_kernels.py, CUDA kernels in test_torch_kernels_gpu.py).
Imports no JAX, so the GPU tests run where JAX is not installed."""
import numpy as np

from repro_torch.serving.kv_cache import PagedAllocator

# reference sweeps (tests/test_kernels.py) + rep-7 cases of qwen2's layout
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 0),
    (1, 128, 384, 4, 1, 64, 0),        # kv longer than q (right-aligned)
    (2, 256, 256, 8, 8, 32, 64),       # sliding window, MHA
    (1, 200, 200, 4, 2, 64, 0),        # non-block-multiple
    (1, 128, 128, 6, 2, 128, 32),      # GQA 3x, window
    (2, 128, 128, 14, 2, 64, 0),       # qwen2: rep 7
    (1, 100, 230, 14, 2, 64, 48),      # rep 7, Skv > Sq, window, ragged
]
PAGED_CASES = [
    (3, 8, 2, 64, 16, 16, 6),
    (2, 4, 4, 32, 8, 8, 4),
    (1, 8, 1, 128, 32, 16, 8),
    (4, 2, 2, 64, 12, 32, 3),
    (4, 14, 2, 64, 32, 16, 6),         # qwen2: rep 7
]
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_PAGED = {"float32": 2e-5, "bfloat16": 3e-2}


def flash_inputs(B, Sq, Skv, H, KV, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, d)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, d)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, d)).astype(np.float32))


def paged_inputs(B, H, KV, d, nb, bs, maxb, seed=0):
    """Allocator-made tables with -1 tails; when there is room, row 0 has
    ctx 0 (an all -1 table) and the last row an unmapped page inside its
    context."""
    rng = np.random.default_rng(seed)
    alloc = PagedAllocator(nb, bs)
    ctx = rng.integers(max(bs // 2, 1), maxb * bs, B)
    if B > 2:
        ctx[0] = 0
    table = np.full((B, maxb), -1, np.int32)
    for b in range(B):
        if ctx[b]:
            blocks = alloc.allocate(b, int(ctx[b]))
            assert blocks is not None
            table[b, :len(blocks)] = blocks
    if B > 2 and ctx[-1] > bs:
        table[-1, 0] = -1
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, KV, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, KV, d)).astype(np.float32)
    return q, kp, vp, table, ctx.astype(np.int32)
