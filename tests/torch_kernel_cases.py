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
    # edges of the tensor-core kernel's 64 x 64 tiles, at rep 7
    (2, 1, 130, 14, 2, 64, 0),         # one query row
    (1, 63, 63, 14, 2, 64, 0),         # a row short of a tile
    (1, 65, 65, 14, 2, 64, 0),         # a row past a tile
    (2, 100, 101, 14, 2, 64, 0),       # Skv = Sq + 1
    (1, 130, 130, 14, 2, 32, 0),       # d = 32 instance
    (1, 130, 130, 14, 2, 128, 0),      # d = 128 instance (two TMA boxes)
    (1, 70, 90, 14, 2, 80, 0),         # d = 80 runs in the 128 instance
    (1, 200, 200, 14, 2, 64, 20),      # window shorter than a key tile
    (1, 320, 320, 4, 2, 128, 100),     # gemma3: rep 2, d = 128, a window of no whole tile
    # d = 256 (gemma-2b, gemma3-4b, paligemma): two warpgroups in bf16, 32-row
    # tiles in f32
    (1, 130, 130, 8, 1, 256, 0),       # MQA, rep 8, a row past two tiles
    (1, 320, 320, 8, 4, 256, 100),     # gemma3-4b: rep 2, a window of no whole tile
    # jamba and mixtral: rep 4 at d = 128; a window over three whole key
    # tiles and a part of a fourth, ragged S
    (1, 400, 400, 8, 2, 128, 200),
]
# a q that is a strided view, (B,H,Sq,d) storage read as (B,Sq,H,d)
FLASH_STRIDED_Q = (2, 96, 96, 14, 2, 64, 0)
PAGED_CASES = [
    (3, 8, 2, 64, 16, 16, 6),
    (2, 4, 4, 32, 8, 8, 4),
    (1, 8, 1, 128, 32, 16, 8),
    (4, 2, 2, 64, 12, 32, 3),
    (4, 14, 2, 64, 32, 16, 6),         # qwen2: rep 7
    (4, 8, 1, 256, 16, 16, 6),         # gemma-2b: d = 256, MQA (f32: two vectors a lane)
]
# SSD scan (b, S, H, P, N, chunk, G): the reference's sweep with B and C
# per head (G = H), a grouped case, and mamba2's head shapes (G = 1)
SSD_CASES = [
    (2, 128, 4, 32, 16, 32, 4),
    (1, 256, 8, 64, 32, 64, 8),
    (2, 64, 2, 16, 128, 64, 2),
    (1, 512, 2, 64, 64, 128, 2),
    (2, 96, 4, 16, 16, 32, 1),         # grouped: 4 heads read one B/C
    (1, 128, 128, 64, 16, 64, 1),      # jamba's heads: H = 128, P = 64, N = 16, G = 1
]
SSD_FULL_WIDTH = (2, 512, 48, 64, 128, 256, 1)
# mamba2's draw of A and dt: da down to -1.6 per token, so that inside a
# 64-token tile exp(cum_q - cum_t) above the diagonal overflows f32
SSD_STRONG_DECAY = (2, 256, 4, 64, 128, 128, 1)
# edges of the one-launch paged kernel's live splits (64 tokens each), on
# qwen2's heads: (bs, max_blk, context per row); every table has -1 tails
PAGED_EDGE_HEADS = (14, 2, 64)         # H, KV, d
PAGED_EDGES = [
    (16, 8, (0, 5, 0)),                # ctx 0 rows come out as exactly 0
    (16, 8, (1, 1, 17)),               # one token
    (16, 8, (64, 128, 63, 65)),        # an exact multiple of the split
    (16, 8, (128, 100, 0, 128)),       # the full table
    (12, 11, (64, 132, 1, 0)),         # pages of 12: splits cross pages
]
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_PAGED = {"float32": 2e-5, "bfloat16": 3e-2}
TOL_SSD = 2e-4


def flash_inputs(B, Sq, Skv, H, KV, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, d)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, d)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, d)).astype(np.float32))


def strided_view(t):
    """The same values as a non-contiguous view whose last dim stays
    contiguous: dims 1 and 2 swapped in storage."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


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


def paged_edge_inputs(bs, maxb, ctx, seed=0):
    """Inputs of a PAGED_EDGES case: each row's pages drawn at random from
    the pool, -1 past its context."""
    H, KV, d = PAGED_EDGE_HEADS
    rng = np.random.default_rng(seed)
    B = len(ctx)
    nb = B * maxb
    perm = rng.permutation(nb).astype(np.int32)
    table = np.full((B, maxb), -1, np.int32)
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        table[b, :n] = perm[b * maxb: b * maxb + n]
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, KV, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, KV, d)).astype(np.float32)
    return q, kp, vp, table, np.asarray(ctx, np.int32)


def ssd_inputs(b, S, H, P, N, G, seed=0, tail=0, strong_decay=False):
    """x, B, C, dt, da at the reference test's scales; B and C (b,S,G,N).
    ``tail`` > 0 zeroes dt and x on each row's last ``tail`` positions, as
    the model's ``true_len`` masking does.  ``strong_decay`` takes the
    strongest decay mamba2's initialisation allows (dt in [0.001, 0.1], A in
    [-16, -1]): dt in [0.09, 0.1], A = -16 on head 0 and in [-16, -1]
    elsewhere, so da reaches -1.6 per token and, within 64 tokens,
    cum_q - cum_t above the diagonal passes 88, where exp overflows f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    B = (rng.normal(size=(b, S, G, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, S, G, N)) * 0.5).astype(np.float32)
    if strong_decay:
        dt = rng.uniform(0.09, 0.1, size=(b, S, H)).astype(np.float32)
        A = rng.uniform(1.0, 16.0, size=(1, 1, H))
        A[..., 0] = 16.0
        da = (-dt * A).astype(np.float32)
    else:
        dt = rng.uniform(0.01, 0.2, size=(b, S, H)).astype(np.float32)
        da = (-dt * rng.uniform(0.5, 2.0, size=(b, S, H))).astype(np.float32)
    if tail:
        x[:, S - tail:] = 0.0
        dt[:, S - tail:] = 0.0
        da[:, S - tail:] = 0.0
    return x, B, C, dt, da


def ssd_recurrence(x, B, C, dt, da):
    """The literal per-token recurrence in numpy (f64), B and C (b,S,G,N)."""
    b, S, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = np.repeat(B, rep, axis=2), np.repeat(C, rep, axis=2)
    h = np.zeros((b, H, P, B.shape[-1]))
    ys = np.zeros((b, S, H, P))
    for t in range(S):
        h = h * np.exp(da[:, t])[..., None, None] + np.einsum(
            "bhn,bhp->bhpn", Bh[:, t], x[:, t] * dt[:, t, :, None])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], h)
    return ys, h
