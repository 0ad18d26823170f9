"""Training launcher: the reduced ("-smoke") config of an arch, trained on
the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --device cpu

A second run on the same ``--ckpt-dir`` resumes from its last committed
checkpoint.  ``--production`` or ``--dryrun`` traces the full-width train
step at the production shape (train_4k) on the meta device against one
H100's memory (``launch/dryrun.py``) and exits; it needs no GPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --production
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the GPU; no GPU "
                         "is an error, never a fall-back to the CPU)")
    ap.add_argument("--production", action="store_true",
                    help="the full config at the production shape on the "
                         "one-card mesh: a dry run (same as --dryrun)")
    ap.add_argument("--dryrun", action="store_true",
                    help="trace the production train step on the meta device "
                         "against the card's memory and exit")
    ap.add_argument("--perf", nargs="*", default=[],
                    help="k=v PerfConfig overrides of the dry run")
    args = ap.parse_args(argv)

    if args.production or args.dryrun:
        from repro_torch.launch import dryrun as DR
        return DR.main(["--arch", args.arch, "--shape", "train_4k",
                        "--mesh", "h100"] +
                       (["--perf"] + args.perf if args.perf else []))

    from repro_torch.configs import get_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import Trainer, TrainConfig
    cfg = get_config(args.arch + "-smoke")
    trainer = Trainer(cfg, TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                                       ckpt_dir=args.ckpt_dir, log_every=10),
                      DataConfig(batch=args.batch, seq_len=args.seq_len),
                      device=args.device)
    if trainer.start_step:
        print(f"auto-resumed from step {trainer.start_step}")
    losses = trainer.run()
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} on {trainer.device}")
    else:
        print(f"done: nothing to train past step {trainer.start_step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
