"""Counting a traced call: flops, bytes, and live and peak memory.

The counterpart of what the reference's dry run reads from XLA
(``launch/hlo.py``: flops and bytes a device from the compiled HLO, peak
memory from ``memory_analysis()``).  The port has no compiled program, so
:class:`OpCounter`, a ``TorchDispatchMode``, watches every aten op of one
eager call, on ``meta`` tensors (the dry run) or on real ones:

- **flops** by ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention);
- **bytes**: the operands plus the outputs of every op that runs a kernel.
  In eager mode every op's output is materialised, so this is the memory
  traffic as ``hlo.py`` counts it for top-level ops.  Views and
  ``empty`` allocate but move nothing; a scatter (``index_put_`` …)
  reads its indices and values and writes as many bytes as its values; a
  ``copy_`` / ``fill_`` writes its destination;
- **live and peak bytes**: every storage counted once however many views
  share it, rounded up to the CUDA caching allocator's 512-byte blocks,
  from the op that creates it until it dies.  A storage is keyed by its
  ``StorageImpl`` (``_cdata``; a meta tensor has no data pointer) and
  freed by a weak reference's callback: PyTorch keeps one Python
  storage object for as long as the storage lives.  An op whose
  implementation allocates a temporary that no dispatched op owns adds
  it to the peak for its duration (``_SCRATCH``).

A kernel wrapper given meta tensors launches nothing: it reports its
kernel's analytic work (``kernels.meta.report``) to
:meth:`OpCounter.add_work`.

A sharded step (``distributed/spmd.py``) runs on one device's shards, so
every count is that device's; its collectives are ``_c10d_functional``
ops, which move no HBM bytes here (as ``hlo.py`` leaves them out of its
bytes) and are summed in :attr:`OpCounter.collectives` by kind, as the
reference's ``collectives_per_device``: the output bytes of each
(``<kind>_payload``) and the bytes a device puts on the wire in a ring of
``g`` devices (all-reduce ``2 (g-1)/g`` of its output, all-gather and
all-to-all ``(g-1)/g``, reduce-scatter ``g-1``), ``count`` and ``total``.
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
BLOCK = 512               # the CUDA caching allocator's rounding

# allocate without running a kernel
_NO_KERNEL = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
              aten.new_empty_strided}
# write as many bytes as their values, into a destination they do not read whole
_SCATTER = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_,
            aten.scatter_add_, aten.scatter_reduce_, aten.index_add_,
            aten.masked_scatter_}
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}


C10D = torch.ops._c10d_functional
# functional collective -> its kind, by the reference's names
_COLLECTIVES = {C10D.all_reduce: "all-reduce", C10D.all_reduce_: "all-reduce",
                C10D.all_gather_into_tensor: "all-gather",
                C10D.reduce_scatter_tensor: "reduce-scatter",
                C10D.all_to_all_single: "all-to-all"}
_WIRE = {"all-reduce": lambda b, g: 2.0 * b * (g - 1) / g,
         "all-gather": lambda b, g: b * (g - 1) / g,
         "reduce-scatter": lambda b, g: b * (g - 1),
         "all-to-all": lambda b, g: b * (g - 1) / g}


def _group_size(args) -> int:
    """The size of a functional collective's group, from its name (the
    last string argument)."""
    name = [a for a in args if isinstance(a, str)][-1]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_world_size(_resolve_process_group(name))


def _input_bytes(args) -> int:
    return args[0].numel() * args[0].element_size()


# ops whose implementation holds a temporary no dispatched op owns: logsumexp
# computes (x - max(x)).exp_() into one tensor the size of its input
_SCRATCH = {aten.logsumexp: _input_bytes}


def rounded(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements, or its storage where
    that is smaller (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def storages(tree) -> dict[int, int]:
    """The distinct storages of ``tree``'s tensors: key -> rounded bytes."""
    return {t.untyped_storage()._cdata: rounded(t.untyped_storage().nbytes())
            for t in _tensors(tree)}


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn(...)`` counts ``c.flops``, ``c.bytes``,
    ``c.live`` and ``c.peak`` (bytes) of the call.  :meth:`track` first
    registers tensors that exist before the call (its arguments) as live.
    ``kernels`` counts the kernel wrappers' meta calls by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels: dict[str, int] = {}
        self.collectives: dict[str, float] = defaultdict(float)
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    # ------------------------------------------------------------ storages
    def _free(self, key: int, _ref) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)

    def _register(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = rounded(st.nbytes())
        self._sizes[key] = n
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key))
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as live; returns the
        bytes this adds."""
        before = self.live
        for t in _tensors(tree):
            self._register(t)
        return self.live - before

    def add_work(self, name: str, nbytes: float, flops: float) -> None:
        self.bytes += nbytes
        self.flops += flops
        self.kernels[name] = self.kernels.get(name, 0) + 1

    # ------------------------------------------------------------ dispatch
    def _op_bytes(self, func, packet, args, ins, outs) -> int:
        if packet in _NO_KERNEL:
            return 0
        mutable = func._schema.is_mutable
        in_keys = {t.untyped_storage()._cdata for t in ins}
        if not mutable and all(t.untyped_storage()._cdata in in_keys for t in outs):
            return 0                                   # a view
        if packet in _SCATTER or packet in _OVERWRITE:
            others = _tensors(args[1:])
            read = sum(tensor_bytes(t) for t in others)
            if packet in _OVERWRITE:
                return read + tensor_bytes(args[0])
            return read + max((tensor_bytes(t) for t in others), default=0)
        return sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet is C10D.wait_tensor:
            # the collective's output itself, as on a device (the meta
            # kernel hands back a new tensor)
            return args[0]
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = _COLLECTIVES.get(packet)
        if kind is not None:
            b = sum(t.numel() * t.element_size() for t in outs)
            c = self.collectives
            c[kind] += _WIRE[kind](b, _group_size(args))
            c[kind + "_payload"] += b
            c["count"] += 1
            c["total"] = sum(v for k, v in c.items() if k in _WIRE)
        else:
            self.bytes += self._op_bytes(func, packet, args, ins, outs)
        for t in outs:
            self._register(t)
        scratch = _SCRATCH.get(packet)
        if scratch is not None:
            self.peak = max(self.peak, self.live + rounded(scratch(args)))
        return out

