"""The port's four examples (``repro_torch.examples``), each run in-process
through its ``main`` on the CPU at its smoke size, as the reference's
``examples/*.py`` run; ``train_tiny`` at 3 steps."""
import torch

from repro_torch.examples import elastic_failover, quickstart, serve_autoscaling, train_tiny
from repro_torch.training import checkpoint as CKPT


def test_quickstart_trains_then_serves(capsys):
    done = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 5 and all(len(r.output) == 6 for r in done)
    assert "over 12 steps on cpu" in out and "served 5/5 requests, 30 tokens" in out


def test_serve_autoscaling_scales_up_and_finishes_the_burst(capsys):
    orch = serve_autoscaling.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 16/16" in out
    assert max(n for _, n in orch.scale_history) > 1
    assert all(e.device.type == "cpu" for e in orch.engines)


def test_elastic_failover_migrates_and_resumes(capsys):
    t2 = elastic_failover.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all 4 requests completed on A (2 migrated)" in out
    assert "injected failure at step 9" in out and t2.start_step == 8
    assert len(t2.losses) == 7 and all(torch.isfinite(torch.tensor(t2.losses)))


def test_train_tiny_trains_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    losses = train_tiny.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", d])
    assert len(losses) == 3 and CKPT.list_steps(d) == [3]
    assert "too few to judge learning" in capsys.readouterr().out
    more = train_tiny.main(["--device", "cpu", "--steps", "5", "--ckpt-dir", d])
    assert len(more) == 2 and "resuming from step 3" in capsys.readouterr().out
