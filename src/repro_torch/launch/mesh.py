"""The port's meshes and the card's constants.

The one-card mesh ``{"data": 1, "model": 1}`` (``h100``) is what the port's
production cells run on; the sharding rules resolve every spec on it to
replication.  The reference's two pod meshes are kept by name, as meshes
of H100s: ``16x16`` (data 16, model 16) and ``2x16x16`` (pod 2, data 16,
model 16).  A :class:`LogicalMesh` holds axis sizes and no device; it
becomes a torch ``DeviceMesh`` (:func:`device_mesh`) over a process group
that the caller opens: the dry run opens the fake backend at the mesh's
world size at rank 0 (:func:`fake_world`), tests and the card open their
own.  As in the reference (whose meshes are built in functions so that
importing never touches device state), importing this module touches no
process group and no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

# NVIDIA H100 SXM (data sheet, dense bf16; HBM3 rate), the roofline bound's
# denominators
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12              # bytes/s per card
# torch.cuda.get_device_properties(0).total_memory, read on an
# "NVIDIA H100 80GB HBM3, 700.00 W" card (chip_smoke.py's fit phase checks
# it against the card it runs on)
HBM_BYTES = 85_017_493_504
# what the caching allocator can never hand out: the CUDA context, the
# loaded modules and the libraries' handles live outside it.  A margin
# above what the card showed (chip_smoke.py's fit phase reads total - free
# - reserved on the card and fails if it is larger)
CONTEXT_BYTES = 2 * 2**30
# a cell fits one card when its peak of allocated bytes is at most this
HBM_USABLE = HBM_BYTES - CONTEXT_BYTES

# the reference's production meshes (src/repro/launch/mesh.py), by the
# names its dry run records
POD_MESHES = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Mesh axis name -> size, with no devices behind it."""
    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh() -> LogicalMesh:
    """The one-card mesh every production cell of the port runs on."""
    return LogicalMesh({"data": 1, "model": 1})


def make_pod_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's ``make_production_mesh(multi_pod=...)`` as a logical
    mesh of H100s: 256 cards (16x16) or 512 (2x16x16)."""
    return LogicalMesh(dict(POD_MESHES["2x16x16" if multi_pod else "16x16"]))


def make_debug_mesh(data: int = 1, model: int = 1) -> LogicalMesh:
    """A logical (data, model) mesh, for resolving the sharding rules."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return LogicalMesh({"data": data, "model": model})


def device_mesh(mesh: LogicalMesh, device_type: str = "cpu"):
    """``mesh`` as a ``DeviceMesh`` over the default process group, which
    the caller has opened at ``mesh.size`` ranks; rank r sits at position r
    of the axes in order (the last axis fastest)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.shape} needs a process group of "
                           f"{mesh.size} ranks")
    ranks = torch.arange(mesh.size).view(*mesh.shape.values())
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """Open torch's fake process group (collectives allocate their outputs
    and move nothing) at ``size`` ranks as ``rank``, and close it after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
