"""Fault-tolerant checkpointing in the reference's format
(``training/checkpoint.py`` of the JAX package): atomic shard files,
auto-resume, restore onto any device.  Either package resumes from what
the other wrote.

Layout:
    <dir>/step_00000120/
        manifest.json      leaf paths, shapes, dtypes, metadata
        shard_00000.npz    leaf arrays, ``leaf_{n}`` (bf16 stored as its uint16 bits)
        COMMIT             written last — a checkpoint without it is garbage

Leaves are numbered in ``jax.tree.flatten``'s order: dict keys sorted at
every level, list entries by index.  The reference restores by that
number, not by path, so a tree is written in its layout: the trainer
stacks its per-layer parameters and AdamW moments into layer groups
first (:func:`reference_layout`, ``params.stack_layers``) and unstacks
them after a restore (:func:`port_layout`).  A leaf's path joins its keys
and list indices with "/".

Writes go to ``step_X.tmp`` and are renamed after the COMMIT marker is
inside, so a crash mid-save can never corrupt the latest checkpoint.
``restore_latest`` skips uncommitted directories.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models import params as P

_SHARD_LEAVES = 1024  # leaves per shard file


def _with_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in ``jax.tree.flatten``'s order: sorted keys."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in _with_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:     # npz can't round-trip bfloat16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         keep_last: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    pairs = _with_paths(tree)
    manifest = {
        "step": step,
        "metadata": metadata or {},
        "leaves": [{"path": p, "shape": list(t.shape), "dtype": _dtype_name(t)}
                   for p, t in pairs],
        "num_shards": -(-len(pairs) // _SHARD_LEAVES),
    }
    for si in range(max(manifest["num_shards"], 1)):
        chunk = pairs[si * _SHARD_LEAVES: (si + 1) * _SHARD_LEAVES]
        arrs = {f"leaf_{si * _SHARD_LEAVES + i:06d}": _to_numpy(t)
                for i, (_, t) in enumerate(chunk)}
        np.savez(os.path.join(tmp, f"shard_{si:05d}.npz"), **arrs)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # retention
    for s in list_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
                out.append(int(name[len("step_"):]))
    return sorted(out)


def restore(ckpt_dir: str, step: int, like_tree, device=None):
    """Restore into the structure of ``like_tree``, leaf by number as the
    reference does, each leaf in its like leaf's dtype; a leaf count or a
    shape that differs raises.  ``device`` (the reference's ``shardings``)
    puts every leaf there; by default each goes where its like leaf is, so
    a checkpoint written on one device restores on another.  Returns
    (tree, manifest)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    recs = manifest["leaves"]
    like = _with_paths(like_tree)
    bad = [p for (p, t), r in zip(like, recs) if list(t.shape) != r["shape"]]
    if len(like) != len(recs) or bad:
        raise ValueError(f"checkpoint {d} does not match the tree: {len(recs)} leaves "
                         f"stored for {len(like)}, shapes differ at {bad[:4]}")
    arrs: list = [None] * len(recs)
    for si in range(max(manifest["num_shards"], 1)):
        with np.load(os.path.join(d, f"shard_{si:05d}.npz")) as z:
            for name in z.files:
                arrs[int(name[len("leaf_"):])] = z[name]

    def load(n, like_leaf):
        t = torch.from_numpy(np.array(arrs[n]))     # a copy: npz arrays are read-only
        if recs[n]["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        dev = like_leaf.device if device is None else device
        return t.to(device=dev, dtype=like_leaf.dtype)

    loaded = {p: load(n, t) for n, (p, t) in enumerate(like)}
    return _map_paths(lambda path, _: loaded[path], like_tree), manifest


def _map_paths(fn, tree, prefix: str = ""):
    """``tree`` rebuilt with each leaf replaced by ``fn(path, leaf)``."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, sub(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def reference_layout(state: dict, cfg) -> dict:
    """A trainer's ``{"params", "opt": {"mu", "nu", "step"}}`` -> the same
    state in the reference's layout (``params.stack_layers`` of the
    parameters and of both moments), as its checkpoints hold it."""
    opt = state["opt"]
    return {"params": P.stack_layers(state["params"], cfg),
            "opt": {"mu": P.stack_layers(opt["mu"], cfg),
                    "nu": P.stack_layers(opt["nu"], cfg), "step": opt["step"]}}


def port_layout(state: dict, cfg) -> dict:
    """The inverse of :func:`reference_layout`."""
    opt = state["opt"]
    return {"params": P.unstack_layers(state["params"], cfg),
            "opt": {"mu": P.unstack_layers(opt["mu"], cfg),
                    "nu": P.unstack_layers(opt["nu"], cfg), "step": opt["step"]}}


def restore_state(ckpt_dir: str, step: int, like_state: dict, cfg, device=None):
    """Restore a trainer's ``{"params", "opt"}`` written at ``step`` by
    either package's ``Trainer`` into the port's layout of ``like_state``.
    The stacked like-tree is built on the meta device, so it costs no
    memory; the leaves land on ``device``, by default the device of
    ``like_state``'s leaves.  Returns (state, manifest)."""
    if device is None:
        device = P.tree_leaves(like_state)[0].device
    meta = P.tree_map(lambda t: t.to("meta"), like_state)
    tree, manifest = restore(ckpt_dir, step, reference_layout(meta, cfg), device)
    return port_layout(tree, cfg), manifest


def restore_latest(ckpt_dir: str, like_tree, device=None):
    steps = list_steps(ckpt_dir)
    if not steps:
        return None, None
    return restore(ckpt_dir, steps[-1], like_tree, device)


class AsyncSaver:
    """Background-thread checkpointing: training never blocks on I/O; the
    previous save is joined before the next begins (bounded memory).  The
    tree is copied to host memory before ``save`` returns, so the next
    step's in-place updates cannot reach what the thread writes."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, ckpt_dir: str, step: int, tree, metadata=None, keep_last=3):
        host_tree = P.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._save, args=(ckpt_dir, step, host_tree, metadata, keep_last),
            daemon=True)
        self._thread.start()

    def _save(self, *args):
        try:
            save(*args)
        except Exception as e:     # raised again by wait(), in the caller's thread
            self._error = e

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
