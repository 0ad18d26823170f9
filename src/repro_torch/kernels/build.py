"""Builds the CUDA kernels from ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, for ``sm_90a``.
Libraries go to ``kernels/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the sources and flags, so a changed source rebuilds
and an unchanged one is reused.  Nothing is built at import time: the first
kernel call builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl"]

_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of each library's launch function: (symbol, argtypes)
SIGNATURES = {
    "paged_attention": ("paged_attention_launch",
                        [_vp] * 9 + [_i] * 7 + [_f, _i, _i, _vp]),
    "flash_attention": ("flash_attention_launch",
                        [_vp] * 4 + [_i] * 6 + [_ll] * 9 + [_f, _i, _i, _i, _vp]),
    "ssd_scan": ("ssd_scan_launch", [_vp] * 7 + [_i] * 7 + [_vp]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}
build_logs: dict[str, str] = {}      # name -> nvcc/ptxas output of the last build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, in parallel.  Raises with the compiler output on failure."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def launcher(name: str):
    """The C launch function of library ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = build([name])[name]
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def dtype_code(t) -> int:
    """The kernels' dtype code of a tensor (csrc/common.cuh: kF32, kBF16)."""
    code = {torch.float32: 0, torch.bfloat16: 1}.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def refuse_autograd(what: str, tensors) -> None:
    """Raise where autograd would record a call: the kernels write their
    outputs through raw pointers, so an output has no backward and the
    gradient through it would silently be zero on the card.  Checked on
    every device, so the CPU tests see it too.  Training takes the plain
    paths (the reference's kernels have no VJP either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: call it under "
                           "torch.no_grad() or on tensors that do not require "
                           "grad (training takes the plain path)")
