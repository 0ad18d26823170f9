"""The model's weights, drawn on the device from the run's seed, in the
port's parameter layout and in the types they are served in.

One ``normal_`` call per dtype fills one flat buffer; every leaf is a view
of it, scaled to its spec's standard deviation.  Leaves the port
initialises at zero (norm scales, the q/k/v biases) are drawn too, at a
small deviation, so that the reference and the port both have to apply
them."""
from __future__ import annotations

import math

import torch

ZERO_INIT_STD = 0.1


def _std(spec) -> float | None:
    if spec.init in ("embed", "normal"):
        return spec.scale
    if spec.init == "zeros":
        return ZERO_INIT_STD
    if spec.init == "fan_in":
        fan_in = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return spec.scale / math.sqrt(max(fan_in, 1))
    if spec.init in ("ones", "const"):
        return None
    raise ValueError(f"weights: no draw for init {spec.init!r}")


def draw(specs, seed: int, device):
    from repro_torch.models import params as P

    leaves = P.tree_leaves(specs)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    bufs = {}
    for dt in sorted({s.dtype for s in leaves}, key=str):
        n = sum(math.prod(s.shape) for s in leaves if s.dtype == dt and _std(s) is not None)
        buf = torch.empty(n, dtype=dt, device=device)
        buf.normal_(generator=gen)
        bufs[dt] = [buf, 0]

    def leaf(s):
        std = _std(s)
        if std is None:
            fill = 1.0 if s.init == "ones" else s.scale
            return torch.full(s.shape, fill, dtype=s.dtype, device=device)
        buf = bufs[s.dtype]
        n = math.prod(s.shape)
        t = buf[0][buf[1]:buf[1] + n].view(s.shape)
        buf[1] += n
        return t.mul_(std)

    return P.tree_map(leaf, specs)
