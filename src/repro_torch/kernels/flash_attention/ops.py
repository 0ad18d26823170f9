"""Flash attention in the model layout: the CUDA kernels on GPU tensors, the
plain version on CPU tensors.

The kernels read q (B,Sq,H,d) and k/v (B,Skv,KV,d) in place through their
strides and mask the ragged edges themselves, so nothing is transposed or
padded on the GPU.  The dtype alone picks the kernel: bf16 runs the
tensor-core (``wgmma``) kernel, whose operands arrive by TMA, so d must be a
multiple of 16 and every base and stride 16-byte aligned; f32 runs the
CUDA-core kernel.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


def _strides(t) -> tuple[int, int, int]:
    """Element strides of dims 0..2; a dim of size 1 is never stepped, so
    it takes its contiguous stride (TMA wants multiples of 16 bytes)."""
    b, S, n, d = t.shape
    sb, ss, sh, _ = t.stride()
    return (sb if b > 1 else S * n * d, ss if S > 1 else n * d, sh if n > 1 else d)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """Model layout: q (B,Sq,H,d); k,v (B,Skv,KV,d) -> (B,Sq,H,d)."""
    global launches
    build.refuse_autograd("attention", (q, k, v))
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
    code = build.dtype_code(q)
    if d > 256:
        raise ValueError(f"head_dim {d} > 256 is not supported")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k, v must be contiguous")
    st = _strides(q) + _strides(k) + _strides(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if q.dtype == torch.bfloat16:
        if d % 16:
            raise ValueError(f"bf16 head_dim {d} is not a multiple of 16")
        if any(p % 16 for p in ptrs) or any(x % 8 for x in st):
            raise ValueError("attention: bf16 q, k, v need 16-byte aligned bases "
                             "and strides that are multiples of 8 elements (TMA), "
                             f"got strides {[t.stride() for t in (q, k, v)]}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    fn = build.launcher("flash_attention")
    rc = fn(*ptrs, out.data_ptr(), B, Sq, Skv, H, KV, d, *st,
            float(scale), int(causal), int(window), code,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
