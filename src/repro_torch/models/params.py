"""Parameter specs, initialisation and conversion from the reference tree.

A model declares its parameters as a tree (dicts and lists) of
:class:`ParamSpec` leaves.  ``init`` turns the tree into tensors on a
device, drawing from an explicit ``torch.Generator``.  The port keeps one
entry per layer (``params["layers"][i]``) where the reference stacks layer
groups along a leading axis for its ``lax.scan``; ``from_jax`` and
``unstack_layers`` unstack, ``stack_layers`` stacks (checkpoints keep the
reference's layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed | const | uniform
    scale: float = 1.0
    fan_in: int | None = None   # contracted input size of a fan_in matrix
    bounds: tuple[float, float] = (0.0, 1.0)   # range of a uniform draw

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of a tree of dicts and lists; with
    ``rest``, over the corresponding leaves of trees of the same structure
    too (dict entries matched by key)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_zip(tree, *rest) -> list[tuple]:
    """The corresponding leaves of trees of one structure, as tuples, in the
    first tree's order."""
    return tree_leaves(tree_map(lambda *leaves: leaves, tree, *rest))


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _draw(generator: torch.Generator, s: ParamSpec, std: float, device) -> torch.Tensor:
    x = torch.randn(s.shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(std).to(device=device, dtype=s.dtype)


def init(generator: torch.Generator, specs, device):
    """Materialise real tensors on ``device``, leaf by leaf in tree order.

    ``embed``/``normal`` draw with std ``scale``; ``fan_in`` with
    ``scale / sqrt(fan_in)``, where fan_in is the spec's own (the size of
    the dims a matmul contracts) or else the second-to-last dim (the last
    of a vector).  The reference always takes the second-to-last dim, which
    for the (D, heads, head_dim) attention weights is the head count.
    ``uniform`` draws from ``bounds``."""

    def _init(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "const":
            return torch.full(s.shape, s.scale, dtype=s.dtype, device=device)
        if s.init in ("embed", "normal"):
            return _draw(generator, s, s.scale, device)
        if s.init == "uniform":
            lo, hi = s.bounds
            x = torch.rand(s.shape, generator=generator, device=generator.device)
            return (x * (hi - lo) + lo).to(device=device, dtype=s.dtype)
        fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2 else s.shape[-1])
        return _draw(generator, s, s.scale / math.sqrt(max(fan_in, 1)), device)

    return tree_map(_init, specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))


def count_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(specs)))


# ---------------------------------------------------------------------------
# conversion from the reference's parameter tree
# ---------------------------------------------------------------------------

def group_period(cfg: ModelConfig) -> int:
    """Length of the reference's repeating layer group (its scan unit)."""
    p = 1
    if cfg.attn_every:
        p = math.lcm(p, cfg.attn_every)
    if cfg.local_ratio:
        p = math.lcm(p, cfg.local_ratio + 1)
    if cfg.num_experts:
        p = math.lcm(p, cfg.moe_every)
    return p


def to_tensor(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> torch, bf16 included: a bf16 array (``ml_dtypes.bfloat16``)
    is reinterpreted through its uint16 bits, which ``torch.from_numpy``
    accepts."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _unstack(tree, n: int) -> list:
    """A subtree whose leaves are stacked along a leading axis of ``n`` ->
    a list of ``n`` subtrees, one per index (views of the stacked
    tensors)."""
    return [tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def _stack(trees: list):
    """A list of subtrees of one structure -> one subtree whose leaves are
    stacked along a new leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def stack_layers(params: dict, cfg: ModelConfig) -> dict:
    """The port's tree (``params["layers"]``, one dict per layer) -> the
    reference's layout, as its checkpoints hold it: ``blocks["m{j}"]``
    holds layer ``g * period + j`` at index ``g`` of its leading axis,
    ``tail["t{i}"]`` a remainder layer ``i``.  An encoder-decoder's
    ``encoder`` and ``decoder`` lists are stacked whole.  Works on any tree
    shaped like the parameters (AdamW's moments too)."""
    if cfg.is_encoder_decoder:
        return {k: _stack(v) if k in ("encoder", "decoder") else v
                for k, v in params.items()}
    period = group_period(cfg)
    groups = cfg.num_layers // period
    if not groups:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers, fewer than one "
                         f"group of {period}")
    layers = params["layers"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["blocks"] = {f"m{j}": _stack([layers[g * period + j] for g in range(groups)])
                     for j in range(period)}
    if groups * period < cfg.num_layers:
        out["tail"] = {f"t{i}": layers[i] for i in range(groups * period, cfg.num_layers)}
    return out


def unstack_layers(tree: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`stack_layers`: the reference's layout -> the
    port's, each layer's leaves views of the stacked tensors."""
    if cfg.is_encoder_decoder:
        out = {k: v for k, v in tree.items() if k not in ("encoder", "decoder")}
        out["encoder"] = _unstack(tree["encoder"], cfg.num_encoder_layers)
        out["decoder"] = _unstack(tree["decoder"], cfg.num_layers)
        return out
    period = group_period(cfg)
    groups = cfg.num_layers // period
    layers = []
    for i in range(cfg.num_layers):
        if i < groups * period:
            g, j = divmod(i, period)
            layers.append(tree_map(lambda a, g=g: a[g], tree["blocks"][f"m{j}"]))
        else:
            layers.append(tree["tail"][f"t{i}"])
    out = {k: v for k, v in tree.items() if k not in ("blocks", "tail")}
    out["layers"] = layers
    return out


def from_jax(tree: dict[str, Any], cfg: ModelConfig, device="cpu") -> dict:
    """The reference's parameter tree (leaves as numpy arrays) -> the port's
    (:func:`unstack_layers` of its tensors).

    Decoder-only LMs: ``tree["blocks"]["m{j}"]`` holds layer ``g * period +
    j`` at index ``g`` of its leading axis; ``tree["tail"]["t{i}"]`` holds a
    remainder layer ``i``.  Both become ``params["layers"][i]``.  An
    encoder-decoder's ``encoder`` and ``decoder`` are stacked along a
    leading axis of ``num_encoder_layers`` and ``num_layers``; each becomes
    a list with one dict per layer, and the other subtrees (embedding,
    position tables, norms) carry over as they are."""
    return unstack_layers(tree_map(lambda a: to_tensor(a, device), tree), cfg)
