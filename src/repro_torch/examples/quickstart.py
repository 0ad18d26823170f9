"""Quickstart: the public API in ~60 lines.

1. pick an architecture config (--arch, reduced)
2. train it a few steps on the synthetic stream
3. serve a few requests through the continuous-batching engine

    PYTHONPATH=src python -m repro_torch.examples.quickstart --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import Trainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU is an error)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + "-smoke")
    print(f"== {args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) ==")

    # ---- train ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(cfg, TrainConfig(steps=args.steps, ckpt_every=50,
                                           ckpt_dir=d, log_every=4),
                          DataConfig(batch=4, seq_len=32), device=args.device)
        losses = trainer.run()
    print(f"train: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {args.steps} steps on {trainer.device}")

    # ---- serve ------------------------------------------------------------
    eng = InferenceEngine(cfg, params=trainer.params, capacity=4, max_len=64,
                          buckets=(8, 16), device=args.device)
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(Request(
            rid=i,
            prompt=[int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(4, 12)))],
            sampling=SamplingParams(max_new_tokens=6, temperature=0.8,
                                    top_k=40)))
    done = eng.run(max_steps=200)
    for r in done:
        print(f"req {r.rid}: ttft={r.ttft*1e3:.0f}ms out={r.output}")
    print(f"served {len(done)}/5 requests, "
          f"{sum(len(r.output) for r in done)} tokens")
    return done


if __name__ == "__main__":
    main()
