"""Kernels of the PyTorch port against the JAX reference.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held to the reference's pure-jnp oracles over the reference's shape sweeps
(``tests/test_kernels.py``) plus qwen2's head layout (14 heads over 2 kv
heads: rep 7), and once per kernel to the Pallas kernel in interpret mode.
The SSD scan is also held to the literal per-token recurrence.
The CUDA kernels themselves are held to the plain versions by the
``gpu``-marked tests in ``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.kernels.ssd_scan.ops import ssd_chunked_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from torch_kernel_cases import (FLASH_CASES, FLASH_STRIDED_Q, PAGED_CASES,
                                SSD_CASES, TOL_FLASH, TOL_PAGED, TOL_SSD,
                                flash_inputs, paged_inputs, ssd_inputs,
                                ssd_recurrence, strided_view)

# jitted: one compile per shape instead of one per op
jax_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))
jax_paged_ref = jax.jit(paged_attention_ref)
jax_ssd_ref_jit = jax.jit(jax_ssd_ref, static_argnames=("chunk",))


def _pair(x: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, ref, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ flash attn
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, Sq, Skv, H, KV, d, window, dtype):
    q, k, v = (_pair(x, dtype) for x in flash_inputs(B, Sq, Skv, H, KV, d))
    ref = jax_attention_ref(q[0].transpose(0, 2, 1, 3), k[0].transpose(0, 2, 1, 3),
                            v[0].transpose(0, 2, 1, 3), causal=True,
                            window=window).transpose(0, 2, 1, 3)
    n0 = flash_ops.launches
    got = flash_ops.attention(q[1], k[1], v[1], causal=True, window=window)
    assert got.shape == (B, Sq, H, d) and got.dtype == q[1].dtype
    assert flash_ops.launches == n0, "CPU tensors must not count a launch"
    _close(got, ref, TOL_FLASH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_strided_q_matches_reference(dtype):
    B, Sq, Skv, H, KV, d, window = FLASH_STRIDED_Q
    q, k, v = (_pair(x, dtype) for x in flash_inputs(B, Sq, Skv, H, KV, d))
    ref = jax_attention_ref(q[0].transpose(0, 2, 1, 3), k[0].transpose(0, 2, 1, 3),
                            v[0].transpose(0, 2, 1, 3), causal=True,
                            window=window).transpose(0, 2, 1, 3)
    qs = strided_view(q[1])
    assert not qs.is_contiguous() and qs.stride(-1) == 1
    got = flash_ops.attention(qs, k[1], v[1], causal=True, window=window)
    _close(got, ref, TOL_FLASH[dtype])


def test_flash_plain_matches_pallas_interpret():
    q, k, v = (_pair(x, "float32") for x in flash_inputs(1, 128, 128, 14, 2, 32, 1))
    ref = jax_attention(q[0], k[0], v[0], causal=True, use_pallas=True,
                        interpret=True)
    _close(flash_ops.attention(q[1], k[1], v[1], causal=True), ref, 2e-5)


# ------------------------------------------------------------ paged attn
@pytest.mark.parametrize("B,H,KV,d,nb,bs,maxb", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_reference(B, H, KV, d, nb, bs, maxb, dtype):
    q, kp, vp, table, ctx = paged_inputs(B, H, KV, d, nb, bs, maxb)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    ref = jax_paged_ref(jq, jk, jv, jnp.asarray(table), jnp.asarray(ctx))
    got = paged_ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                           torch.from_numpy(ctx))
    assert got.shape == (B, H, d) and got.dtype == tq.dtype
    _close(got, ref, TOL_PAGED[dtype])
    if ctx[0] == 0:
        assert bool((got[0] == 0).all()), "a ctx=0 row must come out as 0"


def test_paged_plain_matches_pallas_interpret():
    q, kp, vp, table, ctx = paged_inputs(3, 14, 2, 32, 12, 8, 4, seed=2)
    args = [_pair(x, "float32") for x in (q, kp, vp)]
    ref = jax_paged(*(a[0] for a in args), jnp.asarray(table), jnp.asarray(ctx),
                    use_pallas=True, interpret=True)
    got = paged_ops.paged_decode_attention(*(a[1] for a in args),
                                           torch.from_numpy(table),
                                           torch.from_numpy(ctx))
    _close(got, ref, 2e-5)


# ------------------------------------------------------------- ssd scan
def _ssd_port(x, B, C, dt, da, chunk):
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd_scan(*(torch.from_numpy(a) for a in (x, B, C, dt, da)),
                            chunk=chunk)
    assert ssd_ops.launches == n0, "CPU tensors must not count a launch"
    assert y.dtype == h.dtype == torch.float32
    return y, h


def _expanded(x, B, C, dt, da):
    """The reference's inputs: B and C repeated per head (G = H)."""
    rep = x.shape[2] // B.shape[2]
    return (x, np.repeat(B, rep, axis=2), np.repeat(C, rep, axis=2), dt, da)


@pytest.mark.parametrize("b,S,H,P,N,Q,G", SSD_CASES)
def test_ssd_plain_matches_reference(b, S, H, P, N, Q, G):
    """Reference sweep (G = H, the reference's own layout) and a grouped
    case held against the reference on repeated B and C."""
    args = ssd_inputs(b, S, H, P, N, G)
    y, h = _ssd_port(*args, Q)
    yr, hr = jax_ssd_ref_jit(*(jnp.asarray(a) for a in _expanded(*args)), chunk=Q)
    assert y.shape == (b, S, H, P) and h.shape == (b, H, P, N)
    _close(y, yr, TOL_SSD)
    _close(h, hr, TOL_SSD)


def test_ssd_plain_matches_pallas_interpret():
    args = ssd_inputs(2, 128, 4, 32, 16, 4, seed=1)
    yr, hr = ssd_chunked_scan(*(jnp.asarray(a) for a in args), chunk=32,
                              use_pallas=True, interpret=True)
    y, h = _ssd_port(*args, 32)
    _close(y, yr, TOL_SSD)
    _close(h, hr, TOL_SSD)


@pytest.mark.parametrize("G", [2, 1])
def test_ssd_plain_matches_recurrence(G):
    """The chunked scan equals the literal per-token recurrence."""
    args = ssd_inputs(1, 64, 2, 8, 4, G, seed=2)
    y, h = _ssd_port(*args, 16)
    ys, hs = ssd_recurrence(*args)
    _close(y, ys, 1e-3)
    _close(h, hs, 1e-3)


def test_ssd_plain_zero_tail_is_a_no_op():
    """dt = 0 and x = 0 on a row's tail (``true_len`` masking) leave the
    final state at the state of the last valid token."""
    b, S, H, P, N, Q, tail = 2, 96, 4, 16, 16, 32, 37
    full = ssd_inputs(b, S, H, P, N, 1, seed=3, tail=tail)
    y, h = _ssd_port(*full, Q)
    yr, hr = jax_ssd_ref_jit(*(jnp.asarray(a) for a in _expanded(*full)), chunk=Q)
    _close(y, yr, TOL_SSD)
    _close(h, hr, TOL_SSD)
    _, h_valid = ssd_recurrence(*(a[:, :S - tail] for a in full))
    _close(h, h_valid, 1e-3)
