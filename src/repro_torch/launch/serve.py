"""Serving launcher: cloud-native orchestrated engines on the reduced
("-smoke") config of an arch, on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --stream
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --dryrun
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --dryrun --mesh single

``--stream`` serves through the OpenAI-style completions front-end
(serving/api.py) and prints SSE frames as tokens are emitted — per-token
streaming over the cluster, migrations included.  ``--dryrun`` traces the
full-width decode step at the production shape (decode_32k) on the meta
device against one H100's memory (``launch/dryrun.py``) and exits; it needs
no GPU.  ``--mesh single|multi|both`` traces it per card on the reference's
16x16 / 2x16x16 meshes of H100s instead.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _build_registry(args, cfg):
    """Both serve paths run through one EndpointRegistry — single-model
    serving is simply a one-endpoint registry (the bare ``Orchestrator``
    constructor still works for library callers)."""
    from repro_torch.core.autoscaler import HPAConfig
    from repro_torch.core.endpoints import EndpointRegistry, ModelEndpoint

    return EndpointRegistry([ModelEndpoint(
        name=args.arch, model=cfg, capacity=args.capacity,
        max_replicas=args.max_replicas, cold_start_steps=0, device=args.device,
        hpa=HPAConfig(metric="queue", target=3.0,
                      max_replicas=args.max_replicas,
                      tolerance=0.0, stabilization_s=2.0))])


def _print_models(registry) -> None:
    """The /v1/models surface, as the service banner."""
    from repro_torch.serving import ModelsAPI

    for m in ModelsAPI(registry).list().data:
        print(f"model {m.id}: state={m.state} replicas={m.replicas} "
              f"priority={m.priority}")


def _report(done, rejected, total, n_replicas, n_migrations) -> bool:
    """Success = every request accounted for; REJECTED requests are an
    explicit outcome reported on their own line, never silently folded
    into the served count."""
    print(f"served {len(done)}/{total} requests on {n_replicas} replicas "
          f"({n_migrations} migrations)")
    if rejected:
        print(f"rejected {len(rejected)}/{total} requests "
              f"(rids: {sorted(r.rid for r in rejected)})")
    for r in done[:4]:
        print(f"  rid={r.rid} ttft={r.ttft:.2f}s tokens={len(r.output)} "
              f"finish={r.finish_reason}")
    return len(done) + len(rejected) == total


def _serve_batch(args, cfg, registry) -> int:
    from repro_torch.serving import Request, SamplingParams, State

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        reqs.append(Request(
            rid=i, model=args.arch,
            prompt=[int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(4, 14)))],
            sampling=SamplingParams(max_new_tokens=6, temperature=0.7,
                                    top_k=40)))
        registry.submit(reqs[-1])
    done = registry.run(max_steps=800)
    rejected = [r for r in reqs if r.state is State.REJECTED]
    orch = registry.resolve(args.arch)
    ok = _report(done, rejected, args.requests, registry.total_replicas(),
                 len(orch.migrations.events))
    return 0 if ok else 1


def _serve_stream(args, cfg, registry) -> int:
    """Per-token streaming demo: interleaved SSE streams over the cluster
    front-end, printed as frames arrive."""
    from repro_torch.serving import SSE_DONE, CompletionRequest, CompletionsAPI

    api = CompletionsAPI(registry, model=args.arch)
    rng = np.random.default_rng(0)
    n = min(args.requests, 4)        # a readable number of live streams
    gens = []
    for _ in range(n):
        creq = CompletionRequest(
            prompt=[int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(4, 14)))],
            model=args.arch, max_tokens=6, temperature=0.7, top_k=40,
            stream=True)
        gens.append(api.stream(creq, now=0.0))
    live, finished = list(gens), 0
    while live:                      # round-robin: frames interleave
        for g in list(live):
            try:
                chunk = next(g)
            except StopIteration:
                live.remove(g)
                continue
            sys.stdout.write(chunk.to_sse())
            if chunk.choices[0]["finish_reason"] is not None:
                finished += 1 if chunk.choices[0]["finish_reason"] != \
                    "rejected" else 0
                sys.stdout.write(SSE_DONE)
    print(f"streamed {finished}/{n} requests to completion on "
          f"{registry.total_replicas()} replicas")
    return 0 if finished == n else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-replicas", type=int, default=3)
    ap.add_argument("--stream", action="store_true",
                    help="serve through the completions front-end and print "
                         "per-token SSE frames")
    ap.add_argument("--device", default=None,
                    help="torch device of the replicas (default: the GPU; "
                         "no GPU is an error, never a fall-back to the CPU)")
    ap.add_argument("--dryrun", action="store_true",
                    help="trace the production decode step on the meta device "
                         "against the card's memory and exit")
    ap.add_argument("--mesh", default="h100",
                    choices=["h100", "single", "multi", "both"],
                    help="the dry run's mesh: one card, or the reference's "
                         "16x16 / 2x16x16 meshes of H100s (per card)")
    ap.add_argument("--trace-out", default=None,
                    help="record the engines' step spans and write them with "
                         "the request-lifecycle trace as Chrome/Perfetto "
                         "trace-event JSON to this path")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus text exposition of the cluster "
                         "metrics registry to this path")
    ap.add_argument("--perf", nargs="*", default=[],
                    help="k=v PerfConfig overrides of the dry run")
    args = ap.parse_args(argv)

    if args.dryrun:
        from repro_torch.launch import dryrun as DR
        return DR.main(["--arch", args.arch, "--shape", "decode_32k",
                        "--mesh", args.mesh] +
                       (["--perf"] + args.perf if args.perf else []))

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    resolve_device(args.device)     # no GPU and no --device cpu: raise
    cfg = get_config(args.arch + "-smoke")
    registry = _build_registry(args, cfg)
    # the trace shows each replica's steps beside the requests
    registry.tracer.record_steps = bool(args.trace_out)
    _print_models(registry)
    rc = _serve_stream(args, cfg, registry) if args.stream \
        else _serve_batch(args, cfg, registry)
    _print_models(registry)
    if args.trace_out:
        registry.tracer.write_chrome_trace(args.trace_out)
        print(f"trace written to {args.trace_out} "
              f"({sum(1 for _ in registry.tracer.traces())} traces, "
              f"{len(registry.tracer.step_spans())} steps)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(registry.metrics.render())
        print(f"metrics exposition written to {args.metrics_out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
