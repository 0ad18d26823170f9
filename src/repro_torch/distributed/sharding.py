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
(``launch/mesh.py``).  On the one-card mesh ``{"data": 1, "model": 1}``
every spec resolves to replication and the hook is the identity.  On the
reference's pod meshes (``16x16``, ``2x16x16``) :func:`placements` turns a
spec into one DTensor placement per mesh dim, and the hook
(:meth:`Sharder.__call__`, the reference's ``with_sharding_constraint``)
redistributes a DTensor to the placements of its spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from torch.distributed.tensor import DTensor, Replicate, Shard

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


def spec_axes(spec: Spec, ndim: int) -> list[tuple[str, ...]]:
    """A spec -> the mesh axes of each of ``ndim`` dims, in order (() where
    the dim is replicated)."""
    parts = list(spec) + [None] * (ndim - len(spec))
    return [() if p is None else (p if isinstance(p, tuple) else (p,)) for p in parts]


def placements(spec: Spec, mesh) -> list:
    """A spec -> one DTensor placement per dim of ``mesh`` (anything with
    ``mesh_dim_names`` or ``axis_names``): ``Shard(d)`` on every mesh dim
    that dim ``d`` is split over, ``Replicate()`` on the rest.  A dim over
    fused axes (``("pod", "data")``) is split over them in the spec's
    order, major first, as DTensor splits a dim sharded on several mesh
    dims (in mesh-dim order)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for d, axes in enumerate(spec_axes(spec, len(spec))):
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: fused axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: Spec, mesh_shape: dict) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``
    (the rules shard only dims that divide evenly)."""
    return tuple(n // math.prod(mesh_shape[a] for a in axes)
                 for n, axes in zip(shape, spec_axes(spec, len(shape))))


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
        """The reference's sharding constraint on an activation.  The
        identity where nothing is sharded (no mesh, or one device).  On a
        mesh of several devices ``x`` is a DTensor, redistributed to the
        placements of ``spec_for(x.shape, names)``: a ``Partial`` left by a
        row-parallel product is all-reduced here, a replicated dim that the
        rules shard is cut to this device's part."""
        if _mesh_size(self.mesh) <= 1:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(f"mesh {dict(self.mesh.shape)}: the hook places a "
                            f"DTensor, got {type(x).__name__}")
        spec = self.spec_for(tuple(x.shape), names)
        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))

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

    def batch_shardings(self, batch: dict):
        """Input name -> spec for a batch of tensors whose batch dim leads
        and whose second dim is the sequence (tokens, labels, a vlm's
        patches, an encoder's frames), as the reference's."""
        if self.mesh is None:
            return None

        def one(t):
            names = ("batch", "act_seq") + (None,) * (len(t.shape) - 2)
            return self.spec_for(tuple(t.shape), names[:len(t.shape)])

        return {k: one(v) for k, v in batch.items()}


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
