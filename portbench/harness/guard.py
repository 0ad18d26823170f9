"""The import guard: no run may load JAX or the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot, compared whole) is forbidden: ``repro_torch`` is allowed,
    ``repro`` and ``repro.models`` are not."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if name.split(".", 1)[0] in FORBIDDEN)
