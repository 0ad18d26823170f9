"""A CPU emulation of the bf16 tensor-core SSD-scan kernel
(``src/repro_torch/kernels/csrc/ssd_scan.cu``, ``ssd_wgmma_kernel``), held
to the JAX reference.

``tiled_ssd`` walks the kernel's 64-token tiles with its arithmetic: C B^T
summed in f32 from bf16 inputs (each product exact); M' = (C B^T) o L o dt_t
with the causal mask applied before exp; y_in = M'_hi x + M'_lo x;
y_off = exp(cum) (C h_hi^T + C h_lo^T); and the state update
h <- exp(cum_last) h + (x o wt dt)_hi^T B + (x o wt dt)_lo^T B, every
product accumulated in f32, where a_hi is a rounded to bf16 and a_lo what
that rounding left, rounded to bf16.  The CUDA kernel cannot run here; this
shows on the CPU that its arithmetic holds the reference's 2e-4 bar, and
that one bf16 rounding of each operand would not.

    PYTHONPATH=src python -m pytest -s tests/test_torch_ssd_tiling.py

prints each case's largest error beside that of the same tiles with each
operand rounded once to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunked_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from torch_kernel_cases import (SSD_CASES, SSD_FULL_WIDTH, SSD_STRONG_DECAY,
                                TOL_SSD, ssd_inputs)

T = 64                                       # tokens per tile: wgmma's rows

jax_ssd_ref = jax.jit(ssd_scan_ref, static_argnames=("chunk",))


def _bf16(a):
    return a.to(torch.bfloat16).float()


def _parts(a, split: bool):
    """(hi, lo) with hi + lo ~ a to about 16 bits; lo = 0 unsplit."""
    hi = _bf16(a)
    return (hi, _bf16(a - hi)) if split else (hi, torch.zeros_like(a))


def tiled_ssd(x, B, C, dt, da, *, split: bool = True, mask_after_exp: bool = False):
    """x (b,S,H,P), B,C (b,S,G,N) holding bf16 values, dt,da (b,S,H), all
    f32 tensors -> (y (b,S,H,P), h_last (b,H,P,N)), tile by tile as the
    kernel computes it.  ``split`` False rounds M', h and x o wt dt once to
    bf16; ``mask_after_exp`` multiplies exp(cum_q - cum_t) by the causal
    mask instead of masking first (a fault the strong-decay case shows)."""
    b, S, H, P = x.shape
    R = H // B.shape[2]
    xs = x.permute(0, 2, 1, 3)                               # (b,H,S,P)
    Bs = B.repeat_interleave(R, 2).permute(0, 2, 1, 3)       # (b,H,S,N)
    Cs = C.repeat_interleave(R, 2).permute(0, 2, 1, 3)
    dts, das = dt.permute(0, 2, 1), da.permute(0, 2, 1)      # (b,H,S)
    h = torch.zeros((b, H, P, B.shape[-1]))
    y = torch.zeros((b, H, S, P))
    for s0 in range(0, S, T):
        sl = slice(s0, min(s0 + T, S))
        xt, Bt, Ct, dtt = xs[:, :, sl], Bs[:, :, sl], Cs[:, :, sl], dts[:, :, sl]
        cum = das[:, :, sl].cumsum(-1)
        n = cum.shape[-1]
        below = torch.ones((n, n), dtype=torch.bool).tril()
        diff = cum[..., :, None] - cum[..., None, :]
        if mask_after_exp:
            L = diff.exp() * below
        else:
            L = diff.masked_fill(~below, float("-inf")).exp()
        m_hi, m_lo = _parts(Ct @ Bt.transpose(-1, -2) * L * dtt[..., None, :], split)
        h_hi, h_lo = _parts(h, split)
        y_off = Ct @ h_hi.transpose(-1, -2) + Ct @ h_lo.transpose(-1, -2)
        y[:, :, sl] = y_off * cum.exp()[..., None] + m_hi @ xt + m_lo @ xt
        wt = (cum[..., -1:] - cum).exp() * dtt
        x_hi, x_lo = _parts(xt * wt[..., None], split)
        h = h * cum[..., -1].exp()[..., None, None] \
            + x_hi.transpose(-1, -2) @ Bt + x_lo.transpose(-1, -2) @ Bt
    return y.permute(0, 2, 1, 3), h


def _bf16_inputs(args):
    """The kernel's inputs: x, B, C rounded to bf16 (as f32 arrays), dt and
    da f32."""
    x, B, C, dt, da = args
    rnd = [_bf16(torch.from_numpy(a)).numpy() for a in (x, B, C)]
    return (*rnd, dt, da)


def _reference(x, B, C, dt, da, chunk):
    """The JAX oracle on bf16 x, B, C, with B and C repeated per head."""
    R = x.shape[2] // B.shape[2]
    yr, hr = jax_ssd_ref(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(np.repeat(B, R, 2), jnp.bfloat16),
                         jnp.asarray(np.repeat(C, R, 2), jnp.bfloat16),
                         jnp.asarray(dt), jnp.asarray(da), chunk=chunk)
    return np.asarray(yr), np.asarray(hr)


def _err(got, ref) -> float:
    return float(np.abs(got.numpy() - ref).max())


_CASES = [(*c, False) for c in SSD_CASES] + [(*SSD_FULL_WIDTH, False),
                                             (*SSD_STRONG_DECAY, True)]


@pytest.mark.parametrize("b,S,H,P,N,Q,G,strong", _CASES)
def test_tiled_bf16_matches_reference(b, S, H, P, N, Q, G, strong):
    args = _bf16_inputs(ssd_inputs(b, S, H, P, N, G, strong_decay=strong))
    yr, hr = _reference(*args, Q)
    t_args = [torch.from_numpy(a) for a in args]
    y, h = tiled_ssd(*t_args)
    y1, h1 = tiled_ssd(*t_args, split=False)
    print(f"\n[tiling] b={b} S={S} H={H} P={P} N={N} G={G} strong={strong}: "
          f"max_abs_err hi+lo y {_err(y, yr):.3e} h {_err(h, hr):.3e}; "
          f"one bf16 rounding y {_err(y1, yr):.3e} h {_err(h1, hr):.3e}")
    np.testing.assert_allclose(y.numpy(), yr, atol=TOL_SSD, rtol=TOL_SSD)
    np.testing.assert_allclose(h.numpy(), hr, atol=TOL_SSD, rtol=TOL_SSD)


def test_tiled_matches_pallas_interpret():
    """bf16-valued inputs in f32 through the Pallas kernel (interpret mode)
    at the reference's chunk of 32, against the 64-token tiles."""
    args = _bf16_inputs(ssd_inputs(2, 128, 4, 32, 16, 4, seed=1))
    yr, hr = ssd_chunked_scan(*(jnp.asarray(a) for a in args), chunk=32,
                              use_pallas=True, interpret=True)
    y, h = tiled_ssd(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=TOL_SSD, rtol=TOL_SSD)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=TOL_SSD, rtol=TOL_SSD)


def test_strong_decay_needs_the_mask_before_exp():
    """The strong-decay case overflows exp above the diagonal inside a tile:
    masking after exp gives inf * 0 = NaN, masking before gives the
    reference (test above)."""
    b, S, H, P, N, Q, G = SSD_STRONG_DECAY
    args = [torch.from_numpy(a) for a in
            _bf16_inputs(ssd_inputs(b, S, H, P, N, G, strong_decay=True))]
    assert float(-args[4].min()) > 1.5
    y_bad, _ = tiled_ssd(*args, mask_after_exp=True)
    y, h = tiled_ssd(*args)
    assert not bool(torch.isfinite(y_bad).all())
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
