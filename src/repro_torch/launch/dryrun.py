"""Production dry run: trace every (arch x shape) cell on the meta device,
the reference's ``launch/dryrun.py``.

Each cell's real step function runs at the published widths and the
production shape on ``torch.device("meta")`` under ``cost.OpCounter``
(``build.trace_cell``): nothing is allocated and no device is touched.
``--mesh`` picks where: ``h100`` (the default) is one card; ``single``
(the reference's ``16x16``: data 16, model 16), ``multi`` (``2x16x16``:
pod 2, data 16, model 16) and ``both`` are the reference's meshes, as
meshes of H100s.  On those the program of rank 0 is traced on its shards
(``distributed/spmd.py``) over torch's fake process group, opened at the
mesh's world size (collectives allocate their outputs and move nothing),
and its records carry the reference's mesh names.
For each cell we record (to stdout and --out JSONL):
  * memory — per-device argument, output, temp, alias and peak bytes, and
    ``fits_hbm``: peak <= ``mesh.HBM_USABLE``, one card's memory less
    what its CUDA context holds outside the allocator.  The reference
    holds each chip to v5e's 16 GiB; the port holds each card to an
    H100's 80 GB, so the two fit answers differ by design.  The peak is
    ``torch.cuda.max_memory_allocated``'s; near a full card the default
    allocator can still fail a large block for fragmentation (an H100 did
    at 68.5 of 79.2 GiB), which ``PYTORCH_CUDA_ALLOC_CONF=
    expandable_segments:True`` avoids;
  * flops_per_device / bytes_per_device — the roofline numerators;
  * collectives — on a mesh, the bytes each device's collectives move by
    kind (``cost.OpCounter``; ``total`` the wire bytes);
  * trace_s — the trace's wall seconds (the reference's lower_s and
    compile_s);
  * train cells: ``microbatch`` (n) beside ``traced_microbatches`` (2),
    and ``traced``, the flops and bytes of the traced call alone.  On a
    mesh the sharded train step is not ported: ``status: "not_ported"``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_supported
from repro_torch.configs.perf import PerfConfig, with_overrides
from repro_torch.launch import mesh as M
from repro_torch.launch.build import NotPorted, build_cell, default_perf, trace_cell

MESHES = {"h100": M.make_production_mesh,
          "16x16": M.make_pod_mesh,
          "2x16x16": lambda: M.make_pod_mesh(multi_pod=True)}
MESH_CHOICES = {"h100": ["h100"], "single": ["16x16"], "multi": ["2x16x16"],
                "both": ["16x16", "2x16x16"]}
PERF_KEYS = ("microbatch", "remat", "q_chunk", "xent_chunk", "kv_dtype",
             "accum_dtype", "use_kernels", "partitioning")


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             perf: PerfConfig | None = None, *, verbose: bool = True,
             device_type: str = "cpu") -> dict:
    """Trace one cell.  On a mesh of several cards the caller has opened a
    process group of ``mesh.size`` ranks (:func:`mesh.fake_world`)."""
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
        cell = build_cell(cfg, shape, mesh, perf, device_type=device_type)
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
        coll = ""
        if cell.spmd is not None:
            rec["collectives"] = t["collectives"]
            coll = f"coll/dev={t['collectives'].get('total', 0):.3e}B "
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: OK  "
                  f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                  f"fits={rec['fits_hbm']} "
                  f"flops/dev={t['flops']:.3e} bytes/dev={t['bytes']:.3e} {coll}"
                  f"(trace {rec['trace_s']}s)", flush=True)
    except NotPorted as e:
        rec.update(status="not_ported", reason=str(e))
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: NOT PORTED {e}", flush=True)
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
    ap.add_argument("--mesh", default="h100", choices=list(MESH_CHOICES),
                    help="h100: one card; single / multi / both: the reference's "
                         "16x16 / 2x16x16 meshes of H100s, traced at rank 0")
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--perf", nargs="*", default=None, help="k=v PerfConfig overrides")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) else [args.shape]
    overrides = parse_perf_overrides(args.perf)
    records = []
    for mesh_name in MESH_CHOICES[args.mesh]:
        mesh = MESHES[mesh_name]()
        world = M.fake_world(mesh.size) if mesh.size > 1 else contextlib.nullcontext()
        with world:
            for arch in archs:
                for shape_name in shapes:
                    perf = None
                    if overrides:
                        perf = with_overrides(
                            default_perf(get_config(arch), SHAPES[shape_name],
                                         data=mesh.shape["data"]), **overrides)
                    rec = run_cell(arch, shape_name, mesh, mesh_name, perf)
                    records.append(rec)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
    count = {s: sum(r["status"] == s for r in records)
             for s in ("ok", "skip", "not_ported", "fail")}
    print(f"\ndry-run: {count['ok']} ok, {count['skip']} documented skips, "
          f"{count['not_ported']} not ported, {count['fail']} failures", flush=True)
    return 1 if count["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
