"""The port's checkpointing and training loop on the CPU, the counterparts
of ``tests/test_checkpoint.py``: round trips bit for bit, uncommitted
directories ignored, retention, the async saver (whose snapshot the next
step's in-place update must not reach), a trainer's crash and restart
reproducing the uninterrupted loss trajectory, and the train launcher.
Checkpoints interchange with the reference's, both ways, on
``qwen2-0.5b-smoke`` and ``mamba2-780m-smoke`` at f32: a trainer of one
package resumes from the other's checkpoint and repeats the reference's
uninterrupted losses within 1e-4.
"""
import functools
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import params as P
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer, TrainConfig

REPO = Path(__file__).resolve().parents[1]


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.randn((5,), generator=gen).bfloat16(),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "layers": [{"w": torch.randn((2, 3), generator=gen).bfloat16()},
                       {"w": torch.randn((2, 3), generator=gen).bfloat16()}]}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_save_restore_roundtrip_is_bit_exact(tmp_path):
    t = _tree()
    CKPT.save(str(tmp_path), 7, t, metadata={"loss": 1.5})
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert [r["path"] for r in manifest["leaves"]] == ["a", "b/c", "b/d", "layers/0/w",
                                                       "layers/1/w"]
    assert [r["dtype"] for r in manifest["leaves"]] == ["float32", "bfloat16", "int32",
                                                        "bfloat16", "bfloat16"]
    # like-tree in another key order and dtype: leaves go by path, cast back
    like = {"layers": [{"w": torch.zeros(2, 3)}, {"w": torch.zeros(2, 3)}],
            "b": {"d": torch.zeros((), dtype=torch.int32),
                  "c": torch.zeros(5, dtype=torch.bfloat16)},
            "a": torch.zeros(3, 4)}
    out, manifest = CKPT.restore(str(tmp_path), 7, like)
    assert manifest["step"] == 7 and manifest["metadata"]["loss"] == 1.5
    assert out["layers"][0]["w"].dtype == torch.float32
    like["layers"] = [{"w": torch.zeros(2, 3, dtype=torch.bfloat16)} for _ in range(2)]
    out, _ = CKPT.restore(str(tmp_path), 7, like, device="cpu")
    for x, y in P.tree_zip(t, out):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def test_restore_refuses_a_tree_it_does_not_hold(tmp_path):
    t = _tree()
    CKPT.save(str(tmp_path), 1, t)
    t["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="does not match"):
        CKPT.restore(str(tmp_path), 1, t)


def test_uncommitted_checkpoint_ignored(tmp_path):
    t = _tree()
    CKPT.save(str(tmp_path), 5, t)
    # a crash mid-save of step 9: a directory without COMMIT
    broken = tmp_path / "step_00000009"
    os.makedirs(broken)
    (broken / "manifest.json").write_text("{}")
    (tmp_path / "step_00000011.tmp").mkdir()
    _, manifest = CKPT.restore_latest(str(tmp_path), t)
    assert manifest["step"] == 5
    assert CKPT.restore_latest(str(tmp_path / "none"), t) == (None, None)


def test_retention_keeps_last_k(tmp_path):
    t = _tree()
    for s in range(1, 7):
        CKPT.save(str(tmp_path), s, t, keep_last=3)
    assert CKPT.list_steps(str(tmp_path)) == [4, 5, 6]


def test_async_saver_commits_a_snapshot(tmp_path):
    """The saver commits, and what it writes is the tree as it was at
    ``save``: an in-place update made right after (the next step's) does
    not reach it."""
    big = torch.zeros(1 << 20)
    t = {"w": big, "b": _tree()}
    s = CKPT.AsyncSaver()
    s.save(str(tmp_path), 3, t)
    big.add_(1.0)
    t["b"]["a"].mul_(-1)
    s.wait()
    assert CKPT.list_steps(str(tmp_path)) == [3]
    out, _ = CKPT.restore(str(tmp_path), 3, t)
    assert not out["w"].any()
    assert torch.equal(out["b"]["a"], _tree()["a"])


def test_async_saver_raises_what_the_save_raised(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    s = CKPT.AsyncSaver()
    s.save(str(blocker / "ckpt"), 1, _tree())
    with pytest.raises(OSError):
        s.wait()
    s.wait()   # reported once


def _trainer(ckpt_dir, async_ckpt=False, device="cpu", **kw):
    """qwen2-0.5b-smoke, 8 steps of B=2, S=16, a checkpoint every 3."""
    return Trainer(get_config("qwen2-0.5b-smoke"),
                   TrainConfig(steps=8, ckpt_every=3, ckpt_dir=ckpt_dir, log_every=100,
                               async_ckpt=async_ckpt),
                   DataConfig(batch=2, seq_len=16), device=device, **kw)


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_trainer_crash_restart_is_deterministic(tmp_path, async_ckpt):
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    losses_a = _trainer(a_dir, async_ckpt=async_ckpt).run()
    assert len(losses_a) == 8 and all(np.isfinite(losses_a))
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        _trainer(b_dir, async_ckpt=async_ckpt, fail_at_step=4).run()
    assert CKPT.list_steps(b_dir) == [3]
    t2 = _trainer(b_dir, async_ckpt=async_ckpt)
    assert t2.start_step == 3
    losses_b = t2.run()
    np.testing.assert_allclose(losses_a[3:], losses_b, rtol=0, atol=1e-5)
    assert CKPT.list_steps(b_dir) == [3, 6, 8]
    # the two runs end on the same weights and moments
    like = {"params": t2.params, "opt": t2.opt_state}
    end_a, _ = CKPT.restore_state(a_dir, 8, like, t2.cfg)
    for x, y in P.tree_zip(end_a, like):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


def test_trainer_starts_from_given_weights(tmp_path):
    t = _trainer(str(tmp_path / "a"))
    params = P.tree_map(lambda x: x.clone(), t.params)
    t2 = _trainer(str(tmp_path / "b"), params=params)
    assert t2.params is params
    assert t.run() == t2.run()


def _launch(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "qwen2-0.5b", "--steps", "3", "--batch", "2",
                           "--seq-len", "16", "--ckpt-dir", str(tmp_path / "ckpt"), *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_train_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    r = _launch("--device", "cpu", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "done: loss" in r.stdout and "on cpu" in r.stdout
    assert CKPT.list_steps(str(tmp_path / "ckpt")) == [3]
    r = _launch("--device", "cpu", "--ckpt-every", "2", tmp_path=tmp_path)
    assert r.returncode == 0 and "auto-resumed from step 3" in r.stdout
    # the production dry run, cut short: one micro-batch, whole-sequence
    # query and loss slices
    r = _launch("--dryrun", "--perf", "microbatch=1", "q_chunk=4096", "xent_chunk=4096",
                tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "qwen2-0.5b x train_4k: OK" in r.stdout and "0 failures" in r.stdout


def test_train_launcher_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    r = _launch(tmp_path=tmp_path)
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _trainer(str(tmp_path / "x"), device=None)


# ------------------------------------------------ interchange with the reference
INTERCHANGE = (6, 3)            # steps, the step a checkpoint is taken at
INTERCHANGE_OPT = dict(lr=3e-3, warmup_steps=2)
INTERCHANGE_DATA = dict(batch=2, seq_len=16)
TRAJ_REL = 1e-4


@functools.cache
def _reference_weights(arch: str):
    """The reference's seeded weights in f32, rescaled as the training
    parity tests make them (``test_torch_training._rescaled_f32``)."""
    import jax
    from test_torch_training import _rescaled_f32

    from repro.models import params as JP
    from repro.models.lm import make_model as jax_make_model
    from repro.configs import get_config as jax_get_config

    specs = jax_make_model(jax_get_config(arch)).param_specs()
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(k, specs))(jax.random.PRNGKey(0)))
    noise = np.random.default_rng(4)
    return jax.tree_util.tree_map_with_path(lambda p, a: _rescaled_f32(p, a, noise), raw)


def _reference_trainer(arch, ckpt_dir, steps, monkeypatch):
    """The reference's ``Trainer`` from the f32 weights (its own init swapped
    for them; a checkpoint in ``ckpt_dir`` still wins), synchronous
    checkpoints every ``INTERCHANGE[1]`` steps."""
    import jax.numpy as jnp

    import repro.training.train_loop as JT
    from repro.configs import get_config as jax_get_config
    from repro.training.data import DataConfig as JDataConfig
    from repro.training.optimizer import AdamWConfig as JAdamWConfig

    np32 = _reference_weights(arch)
    init = types.SimpleNamespace(init=lambda key, specs: P.tree_map(jnp.asarray, np32))
    monkeypatch.setattr(JT, "P", init)
    return JT.Trainer(jax_get_config(arch),
                      JT.TrainConfig(steps=steps, ckpt_every=INTERCHANGE[1],
                                     ckpt_dir=str(ckpt_dir), log_every=100,
                                     async_ckpt=False),
                      JDataConfig(**INTERCHANGE_DATA), opt=JAdamWConfig(**INTERCHANGE_OPT))


def _port_trainer(arch, ckpt_dir, steps):
    return Trainer(get_config(arch),
                   TrainConfig(steps=steps, ckpt_every=INTERCHANGE[1], ckpt_dir=str(ckpt_dir),
                               log_every=100, async_ckpt=False),
                   DataConfig(**INTERCHANGE_DATA), opt=AdamWConfig(**INTERCHANGE_OPT),
                   device="cpu", params=P.from_jax(_reference_weights(arch), get_config(arch)))


@pytest.fixture(scope="module", params=["qwen2-0.5b-smoke", "mamba2-780m-smoke"])
def uninterrupted(request, tmp_path_factory):
    """(arch, the reference's uninterrupted losses, its directory holding
    the checkpoints of steps 3 and 6)."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("reference")
    try:
        losses = _reference_trainer(request.param, d, INTERCHANGE[0], mp).run()
    finally:
        mp.undo()
    assert CKPT.list_steps(str(d)) == [INTERCHANGE[1], INTERCHANGE[0]]
    return request.param, losses, d


def test_port_resumes_from_a_reference_checkpoint(uninterrupted, tmp_path):
    """The reference's ``Trainer`` saved at step 3 (stacked layer groups,
    leaves numbered in sorted-key order); the port's resumes there and
    trains on: its losses are the reference's uninterrupted ones."""
    arch, losses, ref_dir = uninterrupted
    k = INTERCHANGE[1]
    shutil.copytree(ref_dir / f"step_{k:08d}", tmp_path / f"step_{k:08d}")
    t = _port_trainer(arch, tmp_path, INTERCHANGE[0])
    assert t.start_step == k
    assert int(t.opt_state["step"]) == k and t.opt_state["mu"]["layers"][0]["ln1"]["scale"].any()
    np.testing.assert_allclose(t.run(), losses[k:], rtol=TRAJ_REL)


def test_reference_resumes_from_a_port_checkpoint(uninterrupted, tmp_path, monkeypatch):
    """The port's ``Trainer`` trains 3 steps and saves; the reference's
    resumes there (by leaf number, as it always restores) and trains on:
    its losses are its own uninterrupted ones."""
    arch, losses, _ = uninterrupted
    k = INTERCHANGE[1]
    port = _port_trainer(arch, tmp_path, k).run()
    np.testing.assert_allclose(port, losses[:k], rtol=TRAJ_REL)
    manifest = json.loads((tmp_path / f"step_{k:08d}" / "manifest.json").read_text())
    ref_manifest = json.loads((uninterrupted[2] / f"step_{k:08d}" / "manifest.json").read_text())
    assert [(r["path"], r["shape"], r["dtype"]) for r in manifest["leaves"]] == [
        (r["path"], r["shape"], r["dtype"]) for r in ref_manifest["leaves"]]
    t = _reference_trainer(arch, tmp_path, INTERCHANGE[0], monkeypatch)
    assert t.start_step == k
    np.testing.assert_allclose(t.run(), losses[k:], rtol=TRAJ_REL)
