"""Where a kernel wrapper's meta-device call reports its work.

On ``meta`` tensors (the dry run) a wrapper launches nothing: it checks the
shapes, returns meta outputs and hands its kernel's analytic bytes and
flops (its ``work``) to :func:`report`.  That goes to the innermost
dispatch mode in force that counts work, one with an ``add_work`` method
(``launch.cost.OpCounter``); with none, nothing is counted.  This module
imports only torch, so the kernels do not depend on the launchers.
"""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def report(name: str, nbytes: float, flops: float) -> None:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        add = getattr(mode, "add_work", None)
        if add is not None:
            add(name, nbytes, flops)
            return
