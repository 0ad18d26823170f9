"""Logical-axis sharding rules -> partition specs, the reference's
``distributed/sharding.py``.

Every parameter and key activation in the model zoo is annotated with logical
axis names (see models/params.py).  A :class:`Sharder` resolves those names to
mesh axes with **per-dim divisibility fallback**: each logical name carries a
priority list of mesh-axis candidates, and the first candidate whose total
size divides the dim (and whose axes are not already taken by an earlier dim
of the same tensor) wins.  Non-divisible dims fall back to replication, so
one rule table serves all 10 architectures (14-head qwen2 silently shards
head_dim instead of heads; 8-expert mixtral shards expert-internal d_ff
instead of the expert axis; …).

ZeRO-1: optimizer moments reuse the param resolution and then additionally
place the ``data`` axis on the largest still-unsharded dim, so optimizer
state is fully partitioned across the data-parallel group.

A partition spec here is a plain tuple, one entry per leading dim (a mesh
axis name, a tuple of fused axis names, or None), trailing Nones dropped,
as ``tuple(jax.sharding.PartitionSpec(...))`` reads.  A mesh is anything
with ``shape`` (axis name -> size) and ``axis_names``
(``launch/mesh.py``).  The port runs on one card, whose mesh
``{"data": 1, "model": 1}`` resolves every spec to replication; the rules
are kept, and held to the reference's, for a mesh of several cards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.models import params as P

# Priority lists: logical axis -> tuple of candidates; each candidate is a
# tuple of mesh axes fused onto that dim.  Missing name or empty tuple =>
# replicated.  Order within a tensor is left-to-right, first-fit.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # weights
    "vocab": (("model",),),
    "mlp": (("model",),),
    "experts": (("model",),),          # qwen3 128e, jamba 16e
    "moe_mlp": (("model",),),          # mixtral fallback (8e not divisible)
    "heads": (("model",),),
    "kv_heads": (("model",),),
    # NOTE deliberately no fallback to sharding "qkv" (head_dim): contracting
    # a model-sharded head_dim turns every attention score matmul into a
    # partial-sum all-reduce at (B,H,S,S) scores shape.  Replicating
    # attention when the head count doesn't divide the model axis is
    # strictly cheaper.
    "qkv": (),
    "state": (),                       # SSM state dim (small)
    "groups": (),
    "experts_r": (),                   # router output dim
    "embed": (),                       # Megatron-style: d_model replicated
    "norm": (),
    "conv": (),
    "pos": (),
    "layers": (),                      # scan axis, never sharded
    # activations
    "batch": (("pod", "data"), ("data",)),
    # xent logits rows: never allowed onto "model" so the vocab dim can take
    # it (replicated unembed re-reads the whole embedding table per chunk)
    "xent_batch": (("pod", "data"), ("data",)),
    "act_seq": (),                     # optionally ("model",) via seq-parallel rules
    # decode KV-cache length: data when batch can't shard (long_500k B=1),
    # model when kv_heads couldn't take it (qwen3-moe kv=4, whisper kv=12 …
    # otherwise the 32k cache replicates over the model axis)
    "act_kv": (("data",), ("model",)),
}

Spec = tuple


def _trim(parts: list) -> Spec:
    while parts and parts[-1] is None:  # trailing Nones are implicit
        parts.pop()
    return tuple(parts)


def _mesh_size(mesh) -> int:
    return math.prod(mesh.shape.values()) if mesh is not None else 1


@dataclasses.dataclass
class Sharder:
    """Resolves logical axis names to partition specs on a fixed mesh.

    ``Sharder(None)`` is the no-mesh variant: the call is the identity and
    every tree query returns None.  On a mesh of one device the call is the
    identity too, since every spec resolves to replication."""

    mesh: Any
    rules: dict[str, tuple[tuple[str, ...], ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    # ------------------------------------------------------------ resolve
    def spec_for(self, shape: tuple[int, ...], names: tuple[str | None, ...]) -> Spec:
        assert self.mesh is not None
        mesh_axes = set(self.mesh.axis_names)
        used: set[str] = set()
        parts: list[Any] = []
        for dim, name in zip(shape, names):
            pick = None
            for cand in self.rules.get(name or "", ()):
                axes = tuple(a for a in cand if a in mesh_axes)
                if not axes or any(a in used for a in axes):
                    continue
                total = math.prod(self.mesh.shape[a] for a in axes)
                if total > 1 and dim % total == 0:
                    pick = axes
                    used.update(axes)
                    break
            parts.append(None if pick is None else (pick[0] if len(pick) == 1 else pick))
        return _trim(parts)

    # ------------------------------------------------------------ act hook
    def __call__(self, x, names):
        """The reference's sharding constraint on an activation: the
        identity where nothing is sharded.  A mesh of several devices has
        no placement in the port (one process, one card)."""
        if _mesh_size(self.mesh) > 1:
            raise NotImplementedError(
                f"mesh {dict(self.mesh.shape)}: placing activations on several "
                "devices is not ported")
        return x

    # ------------------------------------------------------------ trees
    def spec_shardings(self, specs):
        """ParamSpec tree -> spec tree (params, caches)."""
        if self.mesh is None:
            return None
        return P.tree_map(lambda s: self.spec_for(s.shape, s.axes), specs)

    def zero1_spec(self, s: P.ParamSpec) -> Spec:
        """Param sharding + any unused mesh axis placed on the largest
        remaining dims (ZeRO-1 optimizer-state partitioning).  Under zero3
        rules the model axis is free on weights, so moments shard 2-D
        (data via the layer stack + model)."""
        spec = self.spec_for(s.shape, s.axes)
        parts = list(spec) + [None] * (len(s.shape) - len(spec))
        used = {a for p in parts if p is not None
                for a in (p if isinstance(p, tuple) else (p,))}
        for ax in ("data", "model"):
            sz = self.mesh.shape.get(ax, 1)
            if ax in used or sz <= 1:
                continue
            order = sorted(range(len(s.shape)), key=lambda i: -s.shape[i])
            for i in order:
                if parts[i] is None and s.shape[i] % sz == 0:
                    parts[i] = ax
                    used.add(ax)
                    break
        return _trim(parts)

    def zero1_shardings(self, param_specs):
        if self.mesh is None:
            return None
        return P.tree_map(self.zero1_spec, param_specs)


def opt_sharding_tree(sharder: Sharder, param_specs):
    """Specs for the optimizer-state tree produced by training.optimizer
    ({"mu": <params>, "nu": <params>, "step": scalar})."""
    if sharder.mesh is None:
        return None
    moments = sharder.zero1_shardings(param_specs)
    return {"mu": moments, "nu": moments, "step": ()}


def rules_for(partitioning: str) -> dict:
    """Named rule-table variants (the reference's ``PerfConfig.partitioning``;
    the port's one-card runs take ``DEFAULT_RULES``, which is "tp")."""
    rules = dict(DEFAULT_RULES)
    if partitioning == "zero3":
        # FSDP-style: weights *stored* partitioned over data on their widest
        # weight dim and all-gathered at use; batch fans out over every mesh
        # axis so per-device compute matches TP without any TP all-reduces.
        # NOT via the stacked "layers" axis: group counts (gemma3-27b: 10)
        # rarely divide the data axis.  The vocab axis stays model-sharded: a
        # replicated unembed re-reads the whole embedding table every xent
        # chunk.
        for k in ("mlp", "experts", "moe_mlp", "heads", "kv_heads"):
            rules[k] = (("data",),)
        rules["batch"] = (("pod", "data", "model"), ("pod", "data"), ("data",))
    elif partitioning == "dp":
        # pure data-parallel: batch over (pod, data, model) fused; weights
        # replicated (ZeRO-1 still shards moments over data) except the
        # embedding/vocab axis (see zero3 note).
        for k in ("mlp", "experts", "moe_mlp", "heads", "kv_heads"):
            rules[k] = ()
        rules["batch"] = (("pod", "data", "model"), ("pod", "data"), ("data",))
    elif partitioning != "tp":
        raise ValueError(f"unknown partitioning {partitioning!r}")
    return rules
