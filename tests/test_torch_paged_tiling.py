"""A CPU emulation of the one-launch paged decode kernel
(``src/repro_torch/kernels/csrc/paged_attention.cu``,
``paged_decode_kernel``), held to the JAX reference.

``split_paged`` follows the kernel's split and merge: a row's context is cut
into 64-token splits, and only the splits whose first token lies inside the
context (``live_splits``) do any work.  In each split every lane group owns
the tokens t with t % groups == its index and keeps an online softmax (max,
sum, accumulator) in f32; the groups merge, and the live splits merge in
the last split's block.  A row with no context is exactly 0.  The CUDA
kernel cannot run here; this shows on the CPU that merging over the live
splits only computes the Pallas kernel's function at the reference's bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from torch_kernel_cases import (PAGED_CASES, PAGED_EDGES, TOL_PAGED,
                                paged_edge_inputs, paged_inputs)

SPLIT = 64                                   # tokens per split
NEG, MAX_CLAMP, DENOM_FLOOR = -1e30, -1e29, 1e-30

jax_paged_ref = jax.jit(paged_attention_ref)


def live_splits(ctx: int, max_blk: int, bs: int) -> int:
    """Splits of a row that work: those whose first token is in context."""
    return -(-min(max(ctx, 0), max_blk * bs) // SPLIT)


def lane_geometry(d: int, itemsize: int) -> tuple[int, int, int]:
    """(lanes a token row, 16-byte vectors a lane, lane groups of the
    block's 4 warps) of the instance that runs head dim d (``Geo``): a row
    of the instance's head dim (32, 64, 128 or 256) is copies of 16 bytes,
    one a lane, two a lane where they would pass a warp (f32 at 256)."""
    inst = next(n for n in (32, 64, 128, 256) if d <= n)
    copies = inst * itemsize // 16
    vectors = max(1, copies // 32)
    lanes = copies // vectors
    return lanes, vectors, 4 * 32 // lanes


def lane_groups(d: int, itemsize: int) -> int:
    return lane_geometry(d, itemsize)[2]


def _merge(m, l, acc, m2, l2, acc2):
    m_new = np.maximum(m, m2)
    m_safe = np.maximum(m_new, MAX_CLAMP)
    a1 = np.exp(np.maximum(m, MAX_CLAMP) - m_safe)
    a2 = np.exp(np.maximum(m2, MAX_CLAMP) - m_safe)
    return m_new, l * a1 + l2 * a2, acc * a1[:, None] + acc2 * a2[:, None]


def split_paged(q, kp, vp, table, ctx, itemsize: int = 4):
    """q (B,H,d), pools (nb,bs,KV,d), table (B,max_blk), ctx (B,): f32 numpy
    arrays -> (out (B,H,d) f32, live splits per row)."""
    B, H, d = q.shape
    _, bs, KV, _ = kp.shape
    max_blk = table.shape[1]
    rep = H // KV
    groups = lane_groups(d, itemsize)
    qs = q.astype(np.float32) * np.float32(d ** -0.5)
    out = np.zeros((B, H, d), np.float32)
    n_live = [live_splits(int(c), max_blk, bs) for c in ctx]
    for b in range(B):
        limit = min(int(ctx[b]), max_blk * bs)
        for g in range(KV):
            heads = slice(g * rep, g * rep + rep)
            parts = []
            for s in range(n_live[b]):
                state = [(np.full(rep, NEG, np.float32), np.zeros(rep, np.float32),
                          np.zeros((rep, d), np.float32)) for _ in range(groups)]
                for t in range(SPLIT):
                    pos = s * SPLIT + t
                    if pos >= limit or table[b, pos // bs] < 0:
                        continue
                    k = kp[table[b, pos // bs], pos % bs, g]
                    v = vp[table[b, pos // bs], pos % bs, g]
                    m, l, acc = state[t % groups]
                    sc = qs[b, heads] @ k
                    state[t % groups] = _merge(m, l, acc, sc, np.ones(rep, np.float32),
                                               np.outer(np.ones(rep, np.float32), v))
                m, l, acc = state[0]
                for m2, l2, acc2 in state[1:]:
                    m, l, acc = _merge(m, l, acc, m2, l2, acc2)
                parts.append((m, l, acc))
            if not parts:
                continue                         # no context: the row stays 0
            m, l, acc = parts[0]
            for p in parts[1:]:
                m, l, acc = _merge(m, l, acc, *p)
            out[b, heads] = acc / np.maximum(l, DENOM_FLOOR)[:, None]
    return out, n_live


def _as(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _check(q, kp, vp, table, ctx, dtype):
    q, kp, vp = (_as(a, dtype) for a in (q, kp, vp))
    jd = getattr(jnp, dtype)
    ref = np.asarray(jax_paged_ref(jnp.asarray(q, jd), jnp.asarray(kp, jd),
                                   jnp.asarray(vp, jd), jnp.asarray(table),
                                   jnp.asarray(ctx)), np.float32)
    got, n_live = split_paged(q, kp, vp, table, ctx, 4 if dtype == "float32" else 2)
    got = _as(got, dtype)
    tol = TOL_PAGED[dtype]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    for b in np.flatnonzero(ctx == 0):
        assert (got[b] == 0).all(), "a ctx=0 row must come out as exactly 0"
    return n_live


@pytest.mark.parametrize("B,H,KV,d,nb,bs,maxb", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_matches_reference(B, H, KV, d, nb, bs, maxb, dtype):
    _check(*paged_inputs(B, H, KV, d, nb, bs, maxb), dtype)


@pytest.mark.parametrize("bs,maxb,ctx", PAGED_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_edges(bs, maxb, ctx, dtype):
    n_live = _check(*paged_edge_inputs(bs, maxb, ctx), dtype)
    assert n_live == [-(-min(c, maxb * bs) // SPLIT) for c in ctx]


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_lane_geometry_fits_a_warp(d, itemsize):
    """Every instance reads a token row with one warp or part of one,
    16 bytes a vector; only f32 at d = 256 takes two vectors a lane."""
    lanes, vectors, groups = lane_geometry(d, itemsize)
    inst = next(n for n in (32, 64, 128, 256) if d <= n)
    assert lanes <= 32 and 32 % lanes == 0 and groups * lanes == 128
    assert lanes * vectors * 16 == inst * itemsize
    assert vectors == (2 if (inst, itemsize) == (256, 4) else 1)


def test_live_splits_follow_the_context_not_the_table():
    assert [live_splits(c, 64, 16) for c in (0, 1, 63, 64, 65, 300, 1024)] == \
        [0, 1, 1, 1, 2, 5, 16]
    assert live_splits(5000, 8, 16) == 2       # positions past the table are dead


def test_split_merge_matches_pallas_interpret():
    q, kp, vp, table, ctx = paged_inputs(3, 14, 2, 32, 12, 8, 4, seed=2)
    ref = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, ctx)),
                    use_pallas=True, interpret=True)
    got, _ = split_paged(q, kp, vp, table, ctx)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)
