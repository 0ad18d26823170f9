"""The CUDA kernels of the PyTorch port against their plain versions, on a
GPU.  Marked ``gpu``; each test skips without a CUDA device.  No JAX import,
so the file runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from torch_kernel_cases import (FLASH_CASES, FLASH_STRIDED_Q, PAGED_CASES,
                                PAGED_EDGES, SSD_CASES, SSD_FULL_WIDTH,
                                SSD_STRONG_DECAY, TOL_FLASH, TOL_PAGED, TOL_SSD,
                                flash_inputs, paged_edge_inputs, paged_inputs,
                                ssd_inputs, ssd_recurrence, strided_view)


def _close(got: torch.Tensor, ref: torch.Tensor, tol: float):
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(B, Sq, Skv, H, KV, d, window, dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
               for x in flash_inputs(B, Sq, Skv, H, KV, d))
    n0 = flash_ops.launches
    got = flash_ops.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == n0 + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=window).transpose(1, 2)
    _close(got, ref, TOL_FLASH[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_strided_q_matches_plain_on_gpu(dtype):
    _need_cuda()
    B, Sq, Skv, H, KV, d, window = FLASH_STRIDED_Q
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
               for x in flash_inputs(B, Sq, Skv, H, KV, d))
    qs = strided_view(q)
    assert not qs.is_contiguous()
    got = flash_ops.attention(qs, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=window).transpose(1, 2)
    _close(got, ref, TOL_FLASH[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,d,nb,bs,maxb", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_gpu(B, H, KV, d, nb, bs, maxb, dtype):
    _need_cuda()
    q, kp, vp, table, ctx = paged_inputs(B, H, KV, d, nb, bs, maxb)
    dt = getattr(torch, dtype)
    args = (torch.from_numpy(q).to(dt).cuda(), torch.from_numpy(kp).to(dt).cuda(),
            torch.from_numpy(vp).to(dt).cuda(), torch.from_numpy(table).cuda(),
            torch.from_numpy(ctx).cuda())
    n0 = paged_ops.launches
    got = paged_ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches == n0 + 1
    _close(got, paged_attention_ref(*args), TOL_PAGED[dtype])


def _paged_cuda(arrays, dtype):
    q, kp, vp, table, ctx = arrays
    dt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(dt).cuda(), torch.from_numpy(kp).to(dt).cuda(),
            torch.from_numpy(vp).to(dt).cuda(), torch.from_numpy(table).cuda(),
            torch.from_numpy(ctx).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("bs,maxb,ctx", PAGED_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_edges_on_gpu(bs, maxb, ctx, dtype):
    """ctx 0 (exactly 0), 1, a multiple of the 64-token split, the full
    table, pages that splits cross; -1 tails throughout."""
    _need_cuda()
    args = _paged_cuda(paged_edge_inputs(bs, maxb, ctx), dtype)
    got = paged_ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    _close(got, paged_attention_ref(*args), TOL_PAGED[dtype])
    for b, c in enumerate(ctx):
        if c == 0:
            assert bool((got[b] == 0).all()), "a ctx=0 row must come out as 0"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_twice_on_different_contexts_on_gpu(dtype):
    """Back-to-back calls of one shape share the split counters: a counter
    left unreset would skip or misplace the next call's merge."""
    _need_cuda()
    bs, maxb, _ = PAGED_EDGES[3]
    long_ctx = (128, 100, 0, 128)
    short_ctx = (65, 1, 130, 64)
    for ctx in (long_ctx, short_ctx, long_ctx, long_ctx):
        args = _paged_cuda(paged_edge_inputs(bs, maxb, tuple(min(c, maxb * bs) for c in ctx),
                                             seed=sum(ctx)), dtype)
        got = paged_ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        _close(got, paged_attention_ref(*args), TOL_PAGED[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,H,P,N,Q,G", SSD_CASES + [SSD_FULL_WIDTH])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_gpu(b, S, H, P, N, Q, G, dtype):
    """Both get the same (dtype-rounded) inputs; both compute in f32."""
    _need_cuda()
    dt_ = getattr(torch, dtype)
    x, B, C, dt, da = (torch.from_numpy(a).cuda() for a in ssd_inputs(b, S, H, P, N, G))
    x, B, C = x.to(dt_), B.to(dt_), C.to(dt_)
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd_scan(x, B, C, dt, da, chunk=Q)
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1
    yr, hr = ssd_scan_ref(x, B, C, dt, da, chunk=Q)
    _close(y, yr, TOL_SSD)
    _close(h, hr, TOL_SSD)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_strong_decay_on_gpu(dtype):
    """da near -1.6 per token: exp above the diagonal overflows inside a
    tile unless the mask comes first."""
    _need_cuda()
    b, S, H, P, N, Q, G = SSD_STRONG_DECAY
    dt_ = getattr(torch, dtype)
    x, B, C, dt, da = (torch.from_numpy(a).cuda()
                       for a in ssd_inputs(b, S, H, P, N, G, strong_decay=True))
    x, B, C = x.to(dt_), B.to(dt_), C.to(dt_)
    y, h = ssd_ops.ssd_scan(x, B, C, dt, da, chunk=Q)
    torch.cuda.synchronize()
    yr, hr = ssd_scan_ref(x, B, C, dt, da, chunk=Q)
    _close(y, yr, TOL_SSD)
    _close(h, hr, TOL_SSD)


@pytest.mark.gpu
def test_ssd_bf16_rejects_shapes_no_instance_holds():
    _need_cuda()
    for P, N in ((80, 64), (24, 64), (64, 136), (64, 40)):
        x = torch.zeros((1, 64, 2, P), device="cuda", dtype=torch.bfloat16)
        bc = torch.zeros((1, 64, 1, N), device="cuda", dtype=torch.bfloat16)
        dt = torch.zeros((1, 64, 2), device="cuda")
        with pytest.raises(ValueError):
            ssd_ops.ssd_scan(x, bc, bc, dt, dt, chunk=64)


@pytest.mark.gpu
def test_ssd_kernel_matches_recurrence_on_gpu():
    _need_cuda()
    args = ssd_inputs(1, 64, 2, 8, 4, 1, seed=2)
    y, h = ssd_ops.ssd_scan(*(torch.from_numpy(a).cuda() for a in args), chunk=16)
    ys, hs = ssd_recurrence(*args)
    np.testing.assert_allclose(y.cpu().numpy(), ys, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(h.cpu().numpy(), hs, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    q = torch.zeros((2, 4, 16), device="cuda", dtype=torch.float16)
    pool = torch.zeros((4, 8, 1, 16), device="cuda", dtype=torch.float16)
    tbl = torch.zeros((2, 3), dtype=torch.int32, device="cuda")
    ctx = torch.zeros((2,), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged_ops.paged_decode_attention(q, pool, pool, tbl, ctx)
    with pytest.raises(TypeError):
        paged_ops.paged_decode_attention(q.float(), pool.float(), pool.float(),
                                         tbl.long(), ctx)
    x = torch.zeros((1, 8, 2, 272), device="cuda")
    with pytest.raises(ValueError):         # head_dim over the kernels' 256
        flash_ops.attention(x, x, x)
    wide_pool = torch.zeros((4, 8, 1, 272), device="cuda")
    with pytest.raises(ValueError):
        paged_ops.paged_decode_attention(torch.zeros((2, 4, 272), device="cuda"),
                                         wide_pool, wide_pool, tbl, ctx)
    xb = torch.zeros((1, 8, 2, 40), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):         # bf16 d not a multiple of 16
        flash_ops.attention(xb, xb, xb)
    wide = torch.zeros((1, 8, 2, 72), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):         # base off TMA's 16-byte alignment
        flash_ops.attention(wide[..., 4:68], wide[..., :64], wide[..., :64])
    xs = torch.zeros((1, 8, 2, 4), device="cuda")
    bc = torch.zeros((1, 8, 1, 256), device="cuda")
    dt = torch.zeros((1, 8, 2), device="cuda")
    with pytest.raises(ValueError):         # state size over the kernel's 128
        ssd_ops.ssd_scan(xs, bc, bc, dt, dt, chunk=8)
    with pytest.raises(ValueError):         # S not a multiple of the chunk
        ssd_ops.ssd_scan(xs, bc[..., :16], bc[..., :16], dt, dt, chunk=3)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(xs, bc[..., :16], bc[..., :16], dt.half(), dt, chunk=8)
