"""Mamba-2 SSD chunked scan: the CUDA kernel on GPU tensors, the plain
version on CPU tensors.

B and C are taken unexpanded, (b, S, G, N), so the caller never copies
them per head.  ``launches`` counts kernel launches.  A CUDA tensor never
reaches the plain version: it launches the kernel or raises.  On ``meta``
tensors (the dry run) nothing launches: the shapes are checked, the
outputs are meta tensors and :func:`work` goes to ``kernels.meta``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

launches = 0
MAX_STATE = 128          # both kernels cover N <= 128
MAX_HEAD_DIM_BF16 = 64   # the bf16 (wgmma) kernel's instance: P <= 64


def work(b, S, H, P, N, G, Q, itemsize):
    """(bytes, flops) of one call: x, B, C (unexpanded), dt, da read and y,
    h_last (f32) written once; the reference's chunked products at chunk Q:
    C B^T once per group (B and C are shared by the group's heads), and
    M (x dt), C h and the state update for every head."""
    nbytes = (b * S * H * P * itemsize + 2 * b * S * G * N * itemsize
              + 2 * b * S * H * 4 + b * S * H * P * 4 + b * H * P * N * 4)
    flops = 2.0 * b * (S // Q) * (G * Q * Q * N + H * (Q * Q * P + 2 * Q * P * N))
    return nbytes, flops


def ssd_scan(x, B, C, dt, da, *, chunk: int):
    """x (b,S,H,P) and B,C (b,S,G,N) float32 or bfloat16, H % G == 0;
    dt,da (b,S,H) float32; S a multiple of ``chunk``.
    Returns (y (b,S,H,P) f32, h_last (b,H,P,N) f32).

    On the GPU the kernel's tiles need not be ``chunk``: the chunked form
    is the same function for any tile length.  bf16 runs the tensor-core
    kernel, which takes P <= 64 and N <= 128, multiples of 16, and 16-byte
    aligned x, B, C (TMA); f32 runs the CUDA-core kernel, N <= 128."""
    global launches
    tensors = (x, B, C, dt, da)
    build.refuse_autograd("ssd_scan", tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_ref(x, B, C, dt, da, chunk=chunk)
    if not all(t.device == x.device and t.device.type in ("cuda", "meta")
               for t in tensors):
        raise ValueError("ssd_scan: all inputs must be on one CUDA (or meta) device, got "
                         f"{[str(t.device) for t in tensors]}")
    b, S, H, P = x.shape
    G, N = B.shape[-2:]
    if B.shape != (b, S, G, N) or C.shape != B.shape or H % G \
            or dt.shape != (b, S, H) or da.shape != dt.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, dt {tuple(dt.shape)}, "
                         f"da {tuple(da.shape)}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    if N > MAX_STATE:
        raise ValueError(f"state size {N} > {MAX_STATE} is not supported")
    if not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"dtypes differ: {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError("dt and da must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan takes contiguous tensors")
    if x.dtype == torch.bfloat16 and (P > MAX_HEAD_DIM_BF16 or P % 16 or N % 16 or any(
            t.data_ptr() % 16 for t in (x, B, C))):
        raise ValueError(f"bf16 ssd_scan takes P <= {MAX_HEAD_DIM_BF16} and "
                         f"N <= {MAX_STATE}, multiples of 16, and 16-byte "
                         f"aligned x, B, C; got P={P}, N={N}")
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        meta.report("ssd_scan", *work(b, S, H, P, N, G, chunk, x.element_size()))
        return y, h_last
    fn = build.launcher("ssd_scan")
    rc = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
            da.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            b, S, H, P, G, N, build.dtype_code(x),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssd_scan")
    launches += 1
    return y, h_last
