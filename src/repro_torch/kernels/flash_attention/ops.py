"""Flash attention in the model layout: the CUDA kernels on GPU tensors, the
plain version on CPU tensors.

The kernels read q (B,Sq,H,d) and k/v (B,Skv,KV,d) in place through their
strides and mask the ragged edges themselves, so nothing is transposed or
padded on the GPU.  The dtype alone picks the kernel: bf16 runs the
tensor-core (``wgmma``) kernel, whose operands arrive by TMA, so d must be a
multiple of 16 and every base and stride 16-byte aligned; f32 runs the
CUDA-core kernel.  ``launches`` counts kernel launches.  On ``meta``
tensors (the dry run) nothing launches: the shapes are checked, the
output is a meta tensor and :func:`work` goes to ``kernels.meta``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


def visible_pairs(Sq: int, Skv: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs the kernel attends: queries right-aligned to the
    keys (query i sits at position i + Skv - Sq), each seeing the keys at
    or before it under ``causal`` and, with a window, the last ``window``
    of them."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def work(B, Sq, Skv, H, KV, d, window, itemsize, causal: bool = True):
    """(bytes, flops) of one call: q and k, v read once and the output
    written once; two products of 2 d flops for every visible pair of
    every head."""
    nbytes = (2 * B * Sq * H * d + 2 * B * Skv * KV * d) * itemsize
    return nbytes, 4.0 * B * H * d * visible_pairs(Sq, Skv, window, causal)


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
    if not all(t.device == q.device and t.device.type in ("cuda", "meta")
               for t in (q, k, v)):
        raise ValueError("attention: q, k, v must be on one CUDA (or meta) device, got "
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
    if q.device.type == "meta":
        meta.report("flash_attention",
                    *work(B, Sq, Skv, H, KV, d, window, q.element_size(), causal))
        return out
    fn = build.launcher("flash_attention")
    rc = fn(*ptrs, out.data_ptr(), B, Sq, Skv, H, KV, d, *st,
            float(scale), int(causal), int(window), code,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
