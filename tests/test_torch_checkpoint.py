"""The port's checkpointing and training loop on the CPU, the counterparts
of ``tests/test_checkpoint.py``: round trips bit for bit, uncommitted
directories ignored, retention, the async saver (whose snapshot the next
step's in-place update must not reach), a trainer's crash and restart
reproducing the uninterrupted loss trajectory, and the train launcher.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import params as P
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import DataConfig
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
    end_a, _ = CKPT.restore(a_dir, 8, like)
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
    r = _launch("--dryrun", tmp_path=tmp_path)
    assert r.returncode == 2 and "not ported" in r.stderr


def test_train_launcher_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is real")
    r = _launch(tmp_path=tmp_path)
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _trainer(str(tmp_path / "x"), device=None)
