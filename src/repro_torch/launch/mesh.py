"""The port's mesh and the card's constants.

The reference targets TPU v5e pods (a 16 x 16 mesh, or 2 x 16 x 16) and
builds a device mesh for them.  The port runs on one NVIDIA H100: its
production mesh is the logical one-card mesh ``{"data": 1, "model": 1}``,
which holds no device handle, so building it touches no device (the dry
run traces on the ``meta`` device).  The sharding rules resolve against
it to replication.
"""
from __future__ import annotations

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


def make_debug_mesh(data: int = 1, model: int = 1) -> LogicalMesh:
    """A logical (data, model) mesh, for resolving the sharding rules."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return LogicalMesh({"data": data, "model": model})
