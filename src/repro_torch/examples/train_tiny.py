"""Train a small LM for a few hundred steps with fault-tolerant
checkpointing (auto-resume if re-run after an interruption: the default
checkpoint directory is a fixed name under the temporary directory).

    PYTHONPATH=src python -m repro_torch.examples.train_tiny --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_tiny --steps 3 --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer, TrainConfig

# the learning check compares the mean of the first and the last 5 losses:
# it needs runs long enough to leave the 20 warm-up steps well behind
LEARN_CHECK_STEPS = 100


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_tiny"))
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU is an error)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + "-smoke")
    # widen the smoke config a bit so there is something to learn
    cfg = dataclasses.replace(cfg, d_model=args.width, d_ff=args.width * 4,
                              vocab_size=512, num_layers=4)
    trainer = Trainer(
        cfg,
        TrainConfig(steps=args.steps, ckpt_every=25, ckpt_dir=args.ckpt_dir,
                    log_every=20),
        DataConfig(batch=8, seq_len=64, branching=4, seed=21),
        opt=AdamWConfig(lr=3e-3, warmup_steps=20), device=args.device)
    if trainer.start_step:
        print(f"resuming from step {trainer.start_step}")
    losses = trainer.run()
    if not losses:
        print(f"nothing to train past step {trainer.start_step}")
        return losses
    uniform = trainer.data.uniform_nll()
    head = sum(losses[:5]) / len(losses[:5])
    tail = sum(losses[-5:]) / len(losses[-5:])
    print(f"\nloss: {head:.3f} -> {tail:.3f} (uniform baseline {uniform:.3f})")
    if len(losses) >= LEARN_CHECK_STEPS:
        assert tail < head - 0.2, "no learning happened"
    else:
        print(f"{len(losses)} steps: too few to judge learning "
              f"({LEARN_CHECK_STEPS} needed)")
    return losses


if __name__ == "__main__":
    main()
