"""The sharded program: explicit SPMD over a torch ``DeviceMesh``.

The reference writes one global program and lets XLA's partitioner split
it by the sharding rules and the ``shd`` constraints.  Eager PyTorch has no
partitioner, and a dispatch mode sees only the global ops of a DTensor
program (not the local ops or the collectives DTensor issues inside its
own dispatch), so the port writes the partitioned program itself: every
device runs the model's code on its **local** shards, and the layout of
every tensor is the one the rules give it:

- parameters and caches arrive as their shards under
  ``Sharder.spec_for`` of their logical names (``build.build_cell``);
- activations have their batch dim split over the batch axes
  (``spec_for((B,), ("batch",))``) and are whole on every other axis;
- a weight split over an axis that also splits the batch (``zero3``'s
  weights over ``data``) is all-gathered at use (:meth:`Spmd.weights`);
  one split over any other axis runs tensor-parallel: column-parallel
  products leave their output split the same way, row-parallel ones leave
  a partial sum, which :meth:`Spmd.reduce` wraps as a DTensor with a
  ``Partial`` placement and hands to the hook, whose ``redistribute``
  issues the all-reduce;
- decode attention over a cache whose sequence is split
  (``act_kv``) merges its softmax across the devices that hold the parts
  (``layers.attention_decode``: a max and a sum all-reduced, then the
  weighted values); the logits are gathered whole over the vocabulary.

Every op therefore runs, and is counted by ``launch/cost.OpCounter``, at
its local shape, and every collective is a ``_c10d_functional`` op that
the counter sums by kind.  :class:`Spmd` is the ``shd`` argument of the
model code on a mesh; on one card ``shd`` is the identity
(``layers.noop_shd``) and none of this runs.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import Sharder, spec_axes

C10D = torch.ops._c10d_functional
Axes = tuple  # mesh axis names


class Spmd:
    """The hook and the collectives of one sharded step.

    ``sharder`` resolves logical names on the logical mesh; ``mesh`` is the
    matching ``DeviceMesh`` (same axis names, this process's rank on it);
    ``batch`` is the step's global batch and ``kv_len`` its caches' global
    length (a decode step's context, a prefill's ``max_len``)."""

    is_mesh = True

    def __init__(self, sharder: Sharder, mesh, *, batch: int, kv_len: int = 0):
        self.sharder = sharder
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(sharder.mesh.shape)
        if tuple(self.sizes) != self.names:
            raise ValueError(f"logical mesh {self.sizes} and device mesh "
                             f"{self.names} differ")
        self.batch = batch
        self.kv_len = kv_len
        self.batch_axes: Axes = self.axes((batch,), ("batch",))[0]

    # ------------------------------------------------------------ layouts
    def axes(self, shape, names) -> list[Axes]:
        """The mesh axes each dim of a ``shape`` tensor named ``names`` is
        split over."""
        return spec_axes(self.sharder.spec_for(tuple(shape), tuple(names)), len(shape))

    def tp(self, shape, names, dim: int) -> Axes:
        """The axes a weight's ``dim`` runs tensor-parallel over: its split
        axes less those the batch takes (gathered at use)."""
        return tuple(a for a in self.axes(shape, names)[dim] if a not in self.batch_axes)

    def size(self, axes: Axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def coord(self, axes: Axes) -> int:
        """This device's index along ``axes`` fused, the first major."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.mesh.get_local_rank(a)
        return i

    def part(self, n: int, axes: Axes) -> tuple[int, int]:
        """(offset, length) of this device's part of a dim of ``n`` split
        over ``axes``."""
        local = n // self.size(axes)
        return self.coord(axes) * local, local

    # ------------------------------------------------------------ the hook
    def __call__(self, x, names):
        """The reference's ``shd`` hook.  A DTensor (a region's output whose
        layout is not the rules': a partial sum) is redistributed to the
        placements of its spec and handed on as the local shard; a local
        tensor is at its layout already."""
        if isinstance(x, DTensor):
            return self.sharder(x, names).to_local()
        return x

    def shard(self, t, spec):
        """This device's shard of the whole tensor ``t`` under ``spec``, a
        tensor of its own."""
        for d, axes in enumerate(spec_axes(spec, t.dim())):
            if axes:
                off, n = self.part(t.shape[d], axes)
                t = t.narrow(d, off, n)
        return t.clone(memory_format=torch.contiguous_format)

    def placed(self, x, dims: dict, partial: Axes = ()) -> DTensor:
        """The local ``x`` as a DTensor: dim d split over ``dims[d]``, a
        partial sum over ``partial``, whole elsewhere."""
        pl: list = [Replicate()] * len(self.names)
        for d, axes in dims.items():
            for a in axes:
                pl[self.names.index(a)] = Shard(d)
        for a in partial:
            pl[self.names.index(a)] = Partial()
        return DTensor.from_local(x, self.mesh, pl, run_check=False)

    def reduce(self, y, axes: Axes, names=("batch", "act_seq", "embed")):
        """A row-parallel product's partial sums over ``axes`` -> their sum,
        at the layout of ``names`` (the residual stream by default), through
        the hook."""
        if not axes:
            return y
        return self(self.placed(y, {0: self.batch_axes}, partial=axes), names[:y.dim()])

    # ------------------------------------------------------------ collectives
    def _group(self, axis: str) -> str:
        return self.mesh.get_group(axis).group_name

    def all_reduce(self, x, op: str, axes: Axes):
        for a in axes:
            x = C10D.wait_tensor(C10D.all_reduce(x, op, self._group(a)))
        return x

    def all_gather(self, x, dim: int, axes: Axes):
        """Concatenate the parts of ``x``'s ``dim`` over ``axes`` (the first
        major: gathered minor first)."""
        for a in reversed(axes):
            n = self.sizes[a]
            g = C10D.wait_tensor(C10D.all_gather_into_tensor(
                x.contiguous() if dim == 0 else x.movedim(dim, 0).contiguous(),
                n, self._group(a)))
            x = g if dim == 0 else g.movedim(0, dim)
        return x

    def narrow(self, x, dim: int, axes: Axes):
        """This device's part of ``x``'s whole ``dim`` split over ``axes``,
        as a tensor of its own (a view would keep the whole alive)."""
        if not axes:
            return x
        off, n = self.part(x.shape[dim], axes)
        return x.narrow(dim, off, n).clone()

    def relayout(self, x, dim: int, cur: Axes, tgt: Axes):
        """``x``'s ``dim`` from split over ``cur`` to split over ``tgt``:
        gathered over the axes it loses, cut over those it gains."""
        lose = tuple(a for a in cur if a not in tgt)
        if lose:
            x = self.all_gather(x, dim, lose)
        return self.narrow(x, dim, tuple(a for a in tgt if a not in cur))

    def weights(self, p, specs):
        """A layer's local parameters, each leaf split over a batch axis
        all-gathered on that dim (``zero3``: weights stored over data,
        gathered at use).  ``specs`` is the layer's ParamSpec tree."""
        if isinstance(p, dict):
            return {k: self.weights(v, specs[k]) for k, v in p.items()}
        ax = self.axes(specs.shape, specs.axes)
        for d, axes in enumerate(ax):
            lose = tuple(a for a in axes if a in self.batch_axes)
            if lose:
                p = self.all_gather(p, d, lose)
        return p

    # ------------------------------------------------------------ attention
    def kv_heads_for(self, k, H: int, KV: int, h_axes: Axes, kv_axes: Axes):
        """The KV heads the device's query heads read: ``k`` holds the KV
        heads of ``kv_axes`` (dim 2), the queries the heads of ``h_axes``.
        The rules split the KV heads over the query heads' axes or not at
        all (KV divides H).  Split alike, the local heads pair as the
        global ones do; with the KV heads whole, the ones this device's
        query heads map to are cut out (qwen3-moe on 16: 2 query heads a
        device, 4 KV heads, one read)."""
        if tuple(kv_axes) == tuple(h_axes):
            return k
        rep = H // KV
        h0, hl = self.part(H, h_axes)
        return k[:, :, h0 // rep:(h0 + hl - 1) // rep + 1]
