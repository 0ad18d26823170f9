"""End-to-end driver (the paper's scenario): cloud-native serving with
profiling, HPA autoscaling, load balancing and migration — on real engines
of the port (reduced model).

A burst of requests hits one replica; queue pressure trips the HPA law;
the orchestrator spins up replicas (requests route via least-loaded
balancing and can migrate between engines); the fleet scales back down
after the burst drains.

    PYTHONPATH=src python -m repro_torch.examples.serve_autoscaling
    PYTHONPATH=src python -m repro_torch.examples.serve_autoscaling --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.autoscaler import HPAConfig
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.scheduler import SchedulerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU is an error)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch + "-smoke")

    def make_engine():
        return InferenceEngine(cfg, capacity=2, max_len=48, buckets=(8, 16),
                               seed=11,
                               sched=SchedulerConfig(max_prefill_per_step=1),
                               device=args.device)

    orch = Orchestrator(make_engine, OrchestratorConfig(
        min_replicas=1,
        hpa=HPAConfig(metric="queue", target=2.0, max_replicas=4,
                      tolerance=0.0, stabilization_s=2.0,
                      scale_down_cooldown_s=30.0),
        control_every_steps=2))

    rng = np.random.default_rng(0)
    print(f"burst: {args.requests} requests -> 1 replica (capacity 2)")
    for i in range(args.requests):
        orch.submit(Request(
            rid=i,
            prompt=[int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(4, 12)))],
            sampling=SamplingParams(max_new_tokens=4)))

    done = orch.run(max_steps=600)
    print(f"completed {len(done)}/{args.requests}")
    print(f"scale events (t, replicas): "
          f"{[(round(t, 1), n) for t, n in orch.scale_history]}")
    print(f"final replicas: {len(orch.engines)}")
    print(f"migrations: {len(orch.migrations.events)}")
    ttfts = [r.ttft for r in done if r.ttft is not None]
    print(f"mean ttft {np.mean(ttfts)*1e3:.0f}ms  "
          f"p95 {np.percentile(ttfts, 95)*1e3:.0f}ms")
    assert len(done) == args.requests
    return orch


if __name__ == "__main__":
    main()
