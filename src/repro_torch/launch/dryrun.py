"""Production dry run: trace every (arch x shape) cell on the meta device
against one H100, the reference's ``launch/dryrun.py``.

Each cell's real step function runs at the published widths and the
production shape on ``torch.device("meta")`` under ``cost.OpCounter``
(``build.trace_cell``): nothing is allocated and no device is touched.
For each cell we record (to stdout and --out JSONL):
  * memory — per-device argument, output, temp, alias and peak bytes, and
    ``fits_hbm``: peak <= ``mesh.HBM_USABLE``, the card's memory less
    what its CUDA context holds outside the allocator.  The peak is
    ``torch.cuda.max_memory_allocated``'s; near a full card the default
    allocator can still fail a large block for fragmentation (an H100 did
    at 68.5 of 79.2 GiB), which ``PYTORCH_CUDA_ALLOC_CONF=
    expandable_segments:True`` avoids;
  * flops_per_device / bytes_per_device — the roofline numerators;
  * trace_s — the trace's wall seconds (the reference's lower_s and
    compile_s);
  * train cells: ``microbatch`` (n) beside ``traced_microbatches`` (2),
    and ``traced``, the flops and bytes of the traced call alone.
The reference also records collective bytes; the one-card mesh has no
collectives, so there is no such entry.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_supported
from repro_torch.configs.perf import PerfConfig, with_overrides
from repro_torch.launch import mesh as M
from repro_torch.launch.build import build_cell, default_perf, trace_cell

MESHES = {"h100": M.make_production_mesh}
PERF_KEYS = ("microbatch", "remat", "q_chunk", "xent_chunk", "kv_dtype",
             "accum_dtype", "use_kernels")


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             perf: PerfConfig | None = None, *, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: SKIP {reason}", flush=True)
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        cell = build_cell(cfg, shape, mesh, perf)
        rec["perf"] = {k: getattr(cell.perf, k) for k in PERF_KEYS}
        t = trace_cell(cell)
        if cell.traced_microbatches:
            rec.update(microbatch=cell.perf.microbatch,
                       traced_microbatches=cell.traced_microbatches,
                       traced={"flops": t["traced_flops"], "bytes": t["traced_bytes"]})
        mem = t["memory"]
        rec.update(status="ok", memory=mem, flops_per_device=t["flops"],
                   bytes_per_device=t["bytes"], kernels=t["kernels"],
                   trace_s=round(t["trace_s"], 1),
                   fits_hbm=bool(mem["peak_bytes"] <= M.HBM_USABLE))
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: OK  "
                  f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                  f"fits={rec['fits_hbm']} "
                  f"flops/dev={t['flops']:.3e} bytes/dev={t['bytes']:.3e} "
                  f"(trace {rec['trace_s']}s)", flush=True)
    except Exception as e:  # a failure here is a bug in the port's step
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: FAIL {type(e).__name__}: {e}",
                  flush=True)
    return rec


def parse_perf_overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        fields = PerfConfig.__dataclass_fields__
        if k not in fields:
            raise SystemExit(f"--perf: unknown PerfConfig field {k!r}; "
                             f"known: {sorted(fields)}")
        typ = fields[k].type
        if typ in ("int",):
            v = int(v)
        elif typ in ("bool",):
            v = v.lower() in ("1", "true", "yes")
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="h100", choices=list(MESHES))
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--perf", nargs="*", default=None, help="k=v PerfConfig overrides")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) else [args.shape]
    overrides = parse_perf_overrides(args.perf)
    mesh = MESHES[args.mesh]()
    records, failed = [], 0
    for arch in archs:
        for shape_name in shapes:
            perf = None
            if overrides:
                perf = with_overrides(default_perf(get_config(arch), SHAPES[shape_name],
                                                   data=mesh.shape["data"]),
                                      **overrides)
            rec = run_cell(arch, shape_name, mesh, args.mesh, perf)
            records.append(rec)
            failed += rec["status"] == "fail"
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    okc = sum(r["status"] == "ok" for r in records)
    skipc = sum(r["status"] == "skip" for r in records)
    print(f"\ndry-run: {okc} ok, {skipc} documented skips, {failed} failures", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
