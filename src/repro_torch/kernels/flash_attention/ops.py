"""Flash attention in the model layout: the CUDA kernel on GPU tensors, the
plain version on CPU tensors.

The kernel reads q (B,Sq,H,d) and k/v (B,Skv,KV,d) in place through their
strides and masks the ragged edges itself, so nothing is transposed or
padded on the GPU.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """Model layout: q (B,Sq,H,d); k,v (B,Skv,KV,d) -> (B,Sq,H,d)."""
    global launches
    if all(t.device.type == "cpu" for t in (q, k, v)):
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            scale=scale)
        return out.transpose(1, 2)
    if not all(t.device == q.device and t.device.type == "cuda" for t in (q, k, v)):
        raise ValueError("attention: q, k, v must be on one CUDA device, got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    if k.shape != (B, Skv, KV, d) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k, v must be contiguous")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    fn = build.launcher("flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), int(window), build.dtype_code(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
