"""A CPU emulation of the flash-attention kernels
(``src/repro_torch/kernels/csrc/flash_attention.cu``: the bf16 tensor-core
``flash_wgmma_kernel`` and the f32 ``flash_f32_kernel``), held to the JAX
reference.

``tiled_attention`` walks the kernel's tiles with its arithmetic: Q tiles of
64 rows (the f32 kernel's 32 at d > 128) and 64-key K/V tiles, the same
tile-skip rule, Q K^T summed in f32 from bf16 inputs, the running max with
the reference's clamps, P rounded to bf16 before P V, l summed from the
rounded P, and the final divide by max(l, 1e-30).  At d = 256 the bf16
kernel splits O's columns over two warpgroups that each compute the same S,
P and l: each half is taken from its own copy here.  The CUDA kernel cannot
run here; this shows on the CPU that its arithmetic holds the reference's
bf16 bar, and (without the rounding, in f32) that the tiling computes the
Pallas kernel's function.

    PYTHONPATH=src python -m pytest -s tests/test_torch_flash_tiling.py

prints each case's largest error beside that of the same tiles with P kept
in f32 (the CUDA-core kernel's arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref
from torch_kernel_cases import FLASH_CASES, TOL_FLASH, flash_inputs

BQ = BK = 64                                 # query rows, keys per tile
NEG, MAX_CLAMP, DENOM_FLOOR = -1e30, -1e29, 1e-30


def geometry(d: int, dtype: str) -> tuple[int, int]:
    """(query rows a block, warpgroups splitting O's columns) of the kernel
    that runs head dim d in dtype: bf16 splits d > 128 over two
    warpgroups; f32 takes 32 rows above d = 128, where 64 rows of Q and of
    the accumulator would pass the 232,448 bytes of shared memory a block
    may have."""
    if dtype == "bfloat16":
        return BQ, 2 if d > 128 else 1
    return BQ // 2 if d > 128 else BQ, 1


def f32_smem_bytes(bq: int, d: int, warps: int = 4) -> int:
    """The f32 kernel's shared memory (``f32_smem``): K with padded rows,
    V, Q and the accumulator, m and l, and each warp's P row."""
    return 4 * (BK * (d + 1) + BK * d + 2 * bq * d + 2 * bq + warps * BK)

jax_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))


def tiled_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    round_p: bool = True, bq: int = BQ, col_split: int = 1):
    """q (B,Sq,H,d); k,v (B,Skv,KV,d) -> (B,Sq,H,d) in q.dtype, tile by
    tile as the kernel computes it, in Q tiles of ``bq`` rows and O's
    columns in ``col_split`` parts, each with its own S, P, m and l.
    ``round_p`` rounds P to bf16 before P V and before it enters l."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = d ** -0.5
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(rep, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, 1)
    out = torch.zeros((B, H, Sq, d))
    dw = d // col_split                          # O columns of a warpgroup
    for q_lo in range(0, Sq, bq):
        n_rows = min(bq, Sq - q_lo)
        qa_lo = q_lo + Skv - Sq
        qa = torch.arange(n_rows) + qa_lo
        k_end = min(Skv, qa_lo + n_rows) if causal else Skv
        t_begin = (max(0, qa_lo - window + 1) if window else 0) // BK
        n_tiles = max(0, -(-k_end // BK) - t_begin)
        for c0 in range(0, d, dw):
            m = torch.full((B, H, n_rows), NEG)
            l = torch.zeros((B, H, n_rows))
            o = torch.zeros((B, H, n_rows, dw))
            for t in range(t_begin, t_begin + n_tiles):
                keys = torch.arange(t * BK, min(t * BK + BK, Skv))
                s = qf[:, :, q_lo:q_lo + n_rows] @ kf[:, :, keys].transpose(-1, -2) * scale
                ok = torch.ones((n_rows, len(keys)), dtype=torch.bool)
                if causal:
                    ok &= keys[None] <= qa[:, None]
                if window:
                    ok &= keys[None] > qa[:, None] - window
                s = torch.where(ok, s, torch.tensor(NEG))
                m_new = torch.maximum(m, s.amax(-1))
                m_safe = m_new.clamp(min=MAX_CLAMP)
                alpha = torch.exp(m.clamp(min=MAX_CLAMP) - m_safe)
                p = torch.exp(s - m_safe[..., None])
                if round_p:
                    p = p.to(torch.bfloat16).float()
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + p @ vf[:, :, keys, c0:c0 + dw]
                m = m_new
            out[:, :, q_lo:q_lo + n_rows, c0:c0 + dw] = o / l.clamp(min=DENOM_FLOOR)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _reference(q, k, v, window, dtype):
    qj, kj, vj = (jnp.asarray(x, getattr(jnp, dtype)).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    out = jax_attention_ref(qj, kj, vj, causal=True, window=window)
    return np.asarray(out.transpose(0, 2, 1, 3), np.float32)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window", FLASH_CASES)
def test_tiled_bf16_matches_reference(B, Sq, Skv, H, KV, d, window):
    x = flash_inputs(B, Sq, Skv, H, KV, d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    ref = _reference(*x, window, "bfloat16")
    bq, split = geometry(d, "bfloat16")
    got = tiled_attention(q, k, v, window=window, bq=bq, col_split=split).float().numpy()
    p_f32 = tiled_attention(q, k, v, window=window, round_p=False).float().numpy()
    print(f"\n[tiling] B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} d={d} "
          f"window={window}: max_abs_err P in bf16 {np.abs(got - ref).max():.3e}, "
          f"P in f32 {np.abs(p_f32 - ref).max():.3e}")
    tol = TOL_FLASH["bfloat16"]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window", FLASH_CASES)
def test_tiled_f32_matches_reference(B, Sq, Skv, H, KV, d, window):
    """The f32 kernel's tiles (P kept in f32; 32-row Q tiles above d = 128)
    at the reference's f32 bar."""
    x = flash_inputs(B, Sq, Skv, H, KV, d)
    bq, _ = geometry(d, "float32")
    got = tiled_attention(*(torch.from_numpy(a) for a in x), window=window,
                          round_p=False, bq=bq)
    tol = TOL_FLASH["float32"]
    np.testing.assert_allclose(got.numpy(), _reference(*x, window, "float32"),
                               atol=tol, rtol=tol)


def test_f32_tile_fits_shared_memory():
    """f32_smem of the kernel: 64 rows fit up to d = 128, not at 256; 32
    rows do."""
    limit = 232_448
    assert f32_smem_bytes(64, 128) <= limit < f32_smem_bytes(64, 256) == 263_936
    assert f32_smem_bytes(32, 256) == 198_144 <= limit
    assert geometry(256, "float32") == (32, 1) and geometry(128, "float32") == (64, 1)


def test_tiled_f32_matches_pallas_interpret():
    x = flash_inputs(1, 256, 256, 14, 2, 32, seed=1)
    ref = jax_attention(*(jnp.asarray(a) for a in x), causal=True, window=96,
                        use_pallas=True, interpret=True)
    got = tiled_attention(*(torch.from_numpy(a) for a in x), window=96,
                          round_p=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
