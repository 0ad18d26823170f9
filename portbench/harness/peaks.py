"""The H100's published peaks (NVIDIA's data sheet, SXM part, dense rates
at the 700 W limit) and the least time a piece of work can take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_FLOPS_BF16):
    """(least seconds, what sets it): bytes at full bandwidth or operations
    at the peak rate, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
