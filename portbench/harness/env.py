"""Process settings that must be in place before ``torch`` is imported."""
from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = ".portbench_cache"    # under the checkout, listed in .gitignore


def prepare(root: Path) -> None:
    """Fix every build and kernel cache at a path inside the checkout, so
    only a checkout's first run builds, and keep the allocator able to
    grow its segments (the MoE cell fills the card)."""
    cache = root / CACHE_DIR
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    # one process with few threads: the host's own noise stays small
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
