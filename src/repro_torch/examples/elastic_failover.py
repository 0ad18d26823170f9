"""Fault tolerance end-to-end: replica failure during serving + live
request migration, and trainer crash/auto-resume.

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover
    PYTHONPATH=src python -m repro_torch.examples.elastic_failover --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.migration import MigrationManager
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import Trainer, TrainConfig


def serving_failover(device=None):
    print("== serving failover: engine B dies mid-generation ==")
    cfg = get_config("qwen2-0.5b-smoke")
    eng_a = InferenceEngine(cfg, capacity=4, max_len=64, buckets=(8, 16), seed=3,
                            device=device)
    eng_b = InferenceEngine(cfg, capacity=4, max_len=64, buckets=(8, 16), seed=3,
                            device=device)
    eng_b.params = eng_a.params            # same model replica weights

    rng = np.random.default_rng(1)
    reqs = []
    for i in range(4):
        r = Request(rid=i,
                    prompt=[int(x) for x in rng.integers(0, cfg.vocab_size, 8)],
                    sampling=SamplingParams(max_new_tokens=8))
        reqs.append(r)
        (eng_a if i < 2 else eng_b).submit(r)

    for _ in range(5):                     # both engines make progress
        eng_a.step()
        eng_b.step()

    print(f"  engine B 'fails' with {eng_b.pool.used} live requests; "
          "draining to A via live migration")
    mgr = MigrationManager()
    for rid in [q.rid for q in list(eng_b.row_req.values())]:
        ev = mgr.migrate(eng_b, eng_a, rid, now=0.0, src_idx=1, dst_idx=0)
        print(f"  migrated rid={rid}: {ev.bytes/1e3:.1f} kB KV, "
              f"handoff {ev.duration_s*1e3:.1f} ms (cost model)")
    done = eng_a.run(max_steps=200)
    assert len(done) == 4 and all(len(r.output) == 8 for r in done)
    print(f"  all {len(done)} requests completed on A "
          f"({sum(r.migrations for r in done)} migrated)\n")
    return done


def training_failover(device=None):
    print("== training failover: crash at step 9, auto-resume ==")
    cfg = get_config("qwen2-0.5b-smoke")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(steps=15, ckpt_every=4, ckpt_dir=d, log_every=100,
                         async_ckpt=False)
        dc = DataConfig(batch=2, seq_len=16)
        try:
            Trainer(cfg, tc, dc, fail_at_step=9, device=device).run()
        except RuntimeError as e:
            print(f"  {e}")
        t2 = Trainer(cfg, tc, dc, device=device)
        print(f"  restarted: resumed from committed step {t2.start_step}")
        losses = t2.run()
    print(f"  completed to step 15, final loss {losses[-1]:.3f}")
    return t2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU is an error)")
    args = ap.parse_args(argv)
    serving_failover(args.device)
    return training_failover(args.device)


if __name__ == "__main__":
    main()
