#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Thirteen phases, each fatal on failure:

1. build   compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
           (one nvcc per source, in parallel), print the card's name and
           power limit, ptxas's registers and spills, and the HGMMA
           (wgmma) instructions of every kernel, failing if a bf16 flash or
           SSD-scan instance holds none;
2. kernels hold each kernel against its plain PyTorch version in bf16 and
           f32, the attention kernels at qwen2-0.5b shapes (14 heads over 2
           kv heads, head_dim 64; flash also over the tests' cases, tile
           edges and a strided q) and at qwen3-moe-30b-a3b's (32 heads over
           4, head_dim 128), and the SSD scan at mamba2-780m's (48
           heads, P 64, N 128, one group; also at the strongest decay its
           initialisation allows), then time kernel, plain version and
           bound with CUDA events, and each kernel's device time under
           torch.profiler (flash also at B=8, S=1024 and beside SDPA;
           paged decode also at uniform contexts), failing unless a paged
           call is one kernel;
3. qwen2   full-width qwen2-0.5b (random bf16 weights, seed 0) behind
           ``CompletionsAPI`` over ``InferenceEngine(device="cuda")``, on the
           paged and then the dense KV backend, counting kernel launches;
           then the kernel path's logits against ``use_kernels=False``;
4. mamba2  full-width mamba2-780m the same way on the dense backend (SSM
           state has no paged form), with bucketed prefills of two chunks
           through the SSD kernel and a chunked prompt beside decoding rows;
5. cluster the control plane (``repro_torch.core``): an
           ``EndpointRegistry`` endpoint of full-width qwen2-0.5b paged
           replicas sharing one weight tree on the card, routed by the
           cluster cache directory, scaled by the HPA (one to three
           replicas and back) and rebalanced and drained by block-granular
           migration over the simulated transport; 24 requests must all
           finish, with a scale-up, a decode-phase migration, a
           directory-routed prefix hit, paged decode launched for adopted
           rows and gapless per-request token indices.  First a direct
           round trip: a live decode row extracted on one replica and
           adopted on another with an empty prefix cache must land bit for
           bit and decode the same greedy tokens as unmigrated.  Prints
           each migration's blocks, bytes and extract, transfer and adopt
           ms, the payload gather and scatter beside their bound, step wall
           ms by replica count, a profiled window's device busy share and
           served tokens/s;
6. stages  the paper's stage microservices (``core.microservice``):
           qwen2-0.5b whole, 8 prompts of 12 to 400 tokens prefilled as one
           bucket-512 group through ``LM.prefill`` (exactly 24 flash
           launches), then its decode step through ``StagePipeline`` at 1,
           2, 4 and 24 stages, bit-equal to the monolithic ``decode_step``
           with no kernel launched; stage 0 of 4 on 2 replicas (rows 4 + 4)
           within the bf16 logit bar; the profiler-to-HPA loop (rank
           ``stage/<i>``, size the hot stage by the latency HPA, scale it);
           prints each stage count's step wall beside the monolithic one,
           the per-stage ms by CUDA events and their ranking, the split
           step's wall and a profiled staged step's device busy share;
7. examples the four examples (``python -m repro_torch.examples.<name>``)
           as subprocesses on the card, all at once: each must exit 0;
8. family  gemma-2b, gemma3-4b and paligemma-3b whole (18, 34 and 18
           layers, head_dim 256; 5.0, 7.8 and 5.0 GB of bf16 weights, each
           freed before the next): flash and paged decode first checked
           alone at head_dim 256 (bf16 and f32) and timed, flash beside SDPA;
           gemma-2b (8 heads over 1) served like qwen2 on the paged then
           the dense backend, exactly 18 paged launches a decode step and
           18 flash a prefill group; gemma3-4b like gemma3-27b below,
           exactly 34 flash launches a group, 29 of them windowed, and its
           staged decode at 2 and 5 stages bit-equal to the monolithic
           step (ring caches, 4 tail layers on the last stage);
           paligemma-3b through ``InferenceEngine.submit``, 10 requests of
           12 to 500 text tokens, half behind seeded patches, a 513-token
           prompt rejected, no kernel launched (the prefix-LM mask takes
           the plain attention, as in the reference); each decode step
           profiled against the weight-read bound and the kernel path held
           to the plain path (``compare_paths_deep``);
9. moe     qwen3-moe-30b-a3b whole (48 layers, 128 experts top-8, 61 GB of
           bf16 weights drawn on the card after every earlier model is
           freed), served like qwen2 on the paged then the dense backend:
           paged decode must launch 48 times a decode step and flash 48
           times a prefill group; its decode step profiled by part
           (expert products, router, paged decode) against the weight-read
           bound; its kernel path held to the plain path at 4 layers and
           to the f32 plain path at the deepest depth that fits
           (``compare_paths_moe``);
10. gemma3 gemma3-27b whole (62 layers, 52 local with a window of 1024 and
           10 global, 54 GB of bf16 weights, after qwen3-moe is freed):
           flash first checked alone at its heads (32 over 16, head_dim
           128, B=4, S=2048, windows 1024, 0 and 1000; bf16 and f32) and
           timed beside SDPA with the same mask; then 10 requests of 12 to
           3600 tokens on the dense backend (ring caches have no paged
           form), max_len 4096: flash must launch 62 times a prefill group
           and paged decode never; its decode step profiled against the
           weight-read bound; its kernel path held to the plain path at 6
           layers along a bucketed prefill, a chunk and decode across the
           ring's wrap, and to the f32 plain path at the deepest depth that
           fits (``compare_paths_deep``);
11. zoo    the rest of the model zoo, each model freed before the next:
           the SSD scan first checked alone at jamba's heads (H 128, P 64,
           N 16, one group; a right-padded tail too) and flash at 32 heads
           over 8 (head_dim 128) and at a window of 4096 over 8192 tokens,
           bf16 and f32, and timed; jamba-v0.1-52b at 16 of its 32 layers
           (52.0 GB) on ``mamba_traffic``, dense: exactly 14 SSD scans and 2
           flash a prefill group; mixtral-8x7b at 20 of its 32 layers (58.6
           GB) at max_len 8192 on ``gemma_traffic`` and prompts of 4100 to
           6000 tokens: exactly 20 flash a group, every one at window 4096;
           whisper-small whole through ``InferenceEngine.submit`` with
           seeded frames: no kernel, a prompt past the largest bucket
           bounced; each decode step profiled against its bound and each
           kernel path held to its plain path (``compare_paths_moe`` on
           dense paths, ``compare_paths_encdec``);
12. train  training on the plain paths (no kernel may launch): a train step
           of qwen2-0.5b at full width cut to 2 layers, f32, on the card
           held to the same step on the CPU (loss, gradient norm, every
           gradient leaf, AdamW's update); qwen2-0.5b whole (24 layers,
           bf16) through ``Trainer`` on ``BigramStream``, B=8, S=1024, 30
           steps with async checkpoints every 10, losses finite and falling,
           step wall, tokens/s, busy share, peak memory and the share of the
           step's bound; a run failing at step 15 and a resume at step 10
           that repeats the uninterrupted losses under deterministic
           algorithms, its checkpoint read back onto the CPU bit for bit;
           mamba2-780m (B=8, S=1024) and whisper-small (B=8, S=448) whole,
           10 steps each, mamba2 also resumed from its step-5 checkpoint
           (losses within 1e-2 of the loss: its ``cumsum`` has no
           deterministic CUDA form); the kernel wrappers refusing autograd
           on CUDA inputs; ``python -m repro_torch.launch.train`` on the card;
13. fit    the production fit check: ``launch.mesh.HBM_BYTES`` equal to the
           card's memory; the dry run (``launch/dryrun.py``, the meta
           device) of qwen2-0.5b decode_32k, prefill_32k and train_4k,
           mamba2-780m prefill_32k and gemma3-4b long_500k, and of
           jamba-v0.1-52b decode_32k and mixtral-8x7b long_500k, which must
           not fit; the five must each be predicted to fit, and run
           once at full width, under expandable allocator segments (this
           phase only), with their weights, state and inputs allocated
           after a reset of the peak
           (train_4k cut to two micro-batches of 16 x 4096, as the dry
           run traces it): the predicted peak within 10 % of
           ``max_memory_allocated``, kernel launches equal to the dry
           run's meta calls (exactly 24 flash in qwen2's prefill, 48 SSD
           scans in mamba2's), wall and share of the bound; then flash at
           qwen2's and gemma-2b's prefill_32k (q of 2^31 elements) and the
           SSD scan at mamba2's (x of 3.2e9): the last row bit-equal to a
           one-row call, which holds to the plain version (flash on its
           last 512 queries), kernel and cuDNN's causal SDPA timed; the
           bytes the card holds outside the allocator within
           ``launch.mesh.CONTEXT_BYTES``, the room the dry run leaves it;
           then rank 0 of three cells on the reference's pod meshes of
           H100s (``distributed/spmd.py``), at full width over torch's fake
           process group on the card (its collectives allocate their
           outputs and move nothing, so the cells' logits are checked
           only for finiteness, and each kernel is held to its plain
           version at the local shapes the cells call it at):
           qwen3-moe-30b-a3b prefill_32k on 16x16 (8 of 128
           experts, 2 query heads, 48 flash launches), gemma3-27b
           decode_32k on 16x16 (ring and global caches split over the
           model axis, the softmax merged across it) and jamba-v0.1-52b
           prefill_32k on 2x16x16 (local SSM and query heads, 4 flash and
           28 SSD-scan launches, the pod axis): each predicted per-card
           peak within 10 % of ``max_memory_allocated`` and its launches
           equal to the dry run's meta calls.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing
no result, when there is no GPU or any check fails.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when it makes its first handle: a fixed workspace makes
# its products deterministic, which the training phase's resume check needs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the reference's bars (tests/test_kernels.py); the SSD kernel and its plain
# version both compute in f32 from the same inputs, so one bar serves both
# input types
TOL = {("paged", torch.float32): 2e-5, ("paged", torch.bfloat16): 3e-2,
       ("flash", torch.float32): 2e-5, ("flash", torch.bfloat16): 2e-2,
       ("ssd", torch.float32): 2e-4, ("ssd", torch.bfloat16): 2e-4}
LOGIT_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
SEED = 0
DEV = "cuda"
QWEN = "qwen2-0.5b"
MAMBA = "mamba2-780m"
MAMBA_BF16_DEPTH = 4          # layers of the bf16 kernel-vs-plain bar
MAMBA_BF16_ERR_RATIO = 1.5    # full depth: kernel vs plain, distance to f32
# flash timed also at a full batch of the engine's capacity at max_len
FLASH_LONG = (8, 1024)        # B, Sq = Skv
QWEN_HEADS = (14, 2, 64)      # H, KV, head_dim of qwen2-0.5b
MOE_HEADS = (32, 4, 128)      # of qwen3-moe-30b-a3b
PAGED_BATCH = (8, 16, 64)     # B, block size, blocks per table row
PAGED_CTX = [0, 1, 17, 300, 1024, 300, 17, 1]
KERNELS = (      # name, TPU kernel it replaces, serving phase it runs in
    ("paged_attention", "src/repro/kernels/paged_attention/kernel.py:67", "paged"),
    ("flash_attention", "src/repro/kernels/flash_attention/kernel.py:80", "dense"),
    ("ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:67", "mamba2"),
)


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e) -> float:
    """Device time (us) of a torch.profiler key-average row."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_profile(fn, iters: int = 20) -> tuple[float, list[str]]:
    """Device time per call of every kernel ``fn()`` launches, over
    ``iters`` calls under torch.profiler (the time the card is busy, with
    the host's launch cost left out), and the names of the device
    functions that ran.  Each kernel counts its mean duration times the
    launches a call makes of it, so that a trace which lost some of its
    records still reads the kernels' own time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if dev_us(e) > 0]
        if rows and all(e.count % iters == 0 for e in rows):
            break
        # no device activity, or records lost (a kernel counted other than
        # a whole number of times a call): the tracer's failure, not the
        # kernel's, so trace again
        log(f"[profile] trace {attempt + 1} recorded "
            f"{[(e.key[:48], e.count) for e in rows]} for {iters} calls")
    per_call = sum(dev_us(e) / e.count * max(1, round(e.count / iters)) for e in rows)
    return per_call / 1e3, sorted(e.key for e in rows)


def on_device(e) -> bool:
    """Whether a profiler key-average row is the device's own (a kernel or a
    copy), not a host op that launched one."""
    return str(e.device_type).endswith("CUDA")


def device_ms(fn, iters: int = 20) -> float:
    return device_profile(fn, iters)[0]


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, tol):
    """(max |out - ref|, whether every entry is within tol + tol * |ref|)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= tol + tol * ref.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def rel(a, b) -> float:
    """max |a - b| / max |b| (logits)."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-9))


def release() -> None:
    """Return to the card the memory of tensors whose last reference is gone."""
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 1
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    log(f"[build] {gpu_line()}")
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: {[p.name for p in paths.values()]}")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "Performance", "warning")):
                log(f"[build] {name}: {line.strip()}")
    counts = {name: sass_hgmma(path) for name, path in paths.items()}
    for name, c in counts.items():
        log(f"[build] HGMMA instructions per {name} kernel: {json.dumps(c)}")
    # the bf16 instances run on wgmma; the f32 kernels and paged decode
    # hold none
    for name, key, n in (("flash_attention", "flash_wgmma_kernel", 4),
                         ("ssd_scan", "ssd_wgmma_kernel", 1)):
        wgmma = {fn: k for fn, k in counts[name].items() if key in fn}
        check(len(wgmma) == n and all(wgmma.values()),
              f"the bf16 {name} instances hold no HGMMA instruction: {wgmma}")
    return {name: sum(c.values()) for name, c in counts.items()}


def sass_hgmma(path) -> dict[str, int]:
    """HGMMA (wgmma) instructions of each kernel in a built library's SASS."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


# --------------------------------------------------------------- phase 2
def paged_inputs(B, H, KV, d, bs, max_blk, ctx, dtype, gen):
    num_blocks = B * max_blk
    dev = DEV
    q = torch.randn((B, H, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((num_blocks, bs, KV, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((num_blocks, bs, KV, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_blocks, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, max_blk), -1, dtype=torch.int32, device=dev)
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        table[b, :n] = perm[b * max_blk: b * max_blk + n]
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ctx_t


def ssd_inputs(b, S, H, P, N, G, dtype, gen, tail=0, strong=False):
    """At the reference test's scales; dt = 0 and x = 0 on row 0's last
    ``tail`` positions (the model's true_len masking).  ``strong``: the
    strongest decay mamba2's initialisation allows, dt in [0.09, 0.1] and
    A in [-16, -1] (-16 on head 0), da down to -1.6 per token."""
    x = torch.randn((b, S, H, P), generator=gen, device=DEV)
    B = torch.randn((b, S, G, N), generator=gen, device=DEV) * 0.5
    C = torch.randn((b, S, G, N), generator=gen, device=DEV) * 0.5
    if strong:
        dt = torch.rand((b, S, H), generator=gen, device=DEV) * 0.01 + 0.09
        A = torch.rand((H,), generator=gen, device=DEV) * 15 + 1
        A[0] = 16.0
        da = -dt * A
    else:
        dt = torch.rand((b, S, H), generator=gen, device=DEV) * 0.19 + 0.01
        da = -dt * (torch.rand((b, S, H), generator=gen, device=DEV) * 1.5 + 0.5)
    if tail:
        for t in (x, dt, da):
            t[0, S - tail:] = 0.0
    return x.to(dtype), B.to(dtype), C.to(dtype), dt, da


def ssd_recurrence(x, B, C, dt, da):
    """The literal per-token recurrence, f64."""
    x, B, C, dt, da = (t.double() for t in (x, B, C, dt, da))
    b, S, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    h = torch.zeros((b, H, P, B.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(S):
        h = h * da[:, t].exp()[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, 1), h


def check_ssd_cases(H, P, N, G, cases, gen, worst, tag: str) -> None:
    """The SSD scan against its plain version at heads (H, P, N, G), bf16 and
    f32, over ``cases`` of (b, S, chunk, dt0_tail, strong_decay)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[("ssd", dtype)]
        for b, S, Q, tail, strong in cases:
            args = ssd_inputs(b, S, H, P, N, G, dtype, gen, tail, strong)
            y, h = ssd_ops.ssd_scan(*args, chunk=Q)
            torch.cuda.synchronize()
            yr, hr = ssd_scan_ref(*args, chunk=Q)
            (ey, oky), (eh, okh) = max_err(y, yr, tol), max_err(h, hr, tol)
            worst["ssd_scan"] = max(worst["ssd_scan"], ey, eh)
            log(f"[{tag}] ssd_scan {str(dtype)[6:]} b={b} S={S} H={H} P={P} "
                f"N={N} G={G} chunk={Q} dt0_tail={tail} strong_decay={strong}: "
                f"max_abs_err y={ey:.3e} h_last={eh:.3e} "
                f"(max |y| {float(yr.abs().max()):.3e})")
            check(oky and okh, f"ssd_scan {dtype} b={b} S={S} H={H} N={N} chunk={Q} "
                               f"tail={tail} strong={strong} disagrees with its plain version")


def time_ssd(b, S, H, P, N, G, Q, gen) -> dict:
    """Kernel (events and device time), plain version and bound in bf16."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = ssd_inputs(b, S, H, P, N, G, torch.bfloat16, gen)

    def kernel():
        return ssd_ops.ssd_scan(*args, chunk=Q)
    b_ms, b_by = bound(*ssd_ops.work(b, S, H, P, N, G, Q, 2), torch.bfloat16)
    dev, names = device_profile(kernel)
    return dict(shape=f"b={b} S={S} H={H} P={P} N={N} G={G}", ms=cuda_ms(kernel),
                plain_ms=cuda_ms(lambda: ssd_scan_ref(*args, chunk=Q), iters=20),
                bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=dev,
                device_kernels=names)


def check_ssd(worst):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    H, P, N, G = 48, 64, 128, 1
    check_ssd_cases(H, P, N, G, [(2, 256, 256, 0, False), (4, 512, 256, 0, False),
                                 (1, 1024, 256, 0, False), (2, 256, 64, 0, False),
                                 (1, 512, 256, 137, False), (2, 256, 128, 0, True)],
                    gen, worst, "kernels")
    args = ssd_inputs(1, 64, 2, 8, 4, 1, torch.float32, gen)
    y, h = ssd_ops.ssd_scan(*args, chunk=16)
    ys, hs = ssd_recurrence(*args)
    (ey, oky), (eh, okh) = max_err(y, ys, 1e-3), max_err(h, hs, 1e-3)
    log(f"[kernels] ssd_scan vs per-token recurrence f32 b=1 S=64 H=2 P=8 N=4: "
        f"max_abs_err y={ey:.3e} h_last={eh:.3e}")
    check(oky and okh, "ssd_scan disagrees with the per-token recurrence")

    # one bucket-512 prefill group of mamba2 (4 rows), bf16 inputs
    b, S, Q = 4, 512, 256
    row = time_ssd(b, S, H, P, N, G, Q, gen)
    # device time by row count at S = 512: one row's 48 blocks leave most
    # SMs idle, so b = 1 reads one block's walk of the sequence
    by_rows = {}
    for rows in (1, 2, 8):
        a = ssd_inputs(rows, S, H, P, N, G, torch.bfloat16, gen)
        by_rows[rows] = device_ms(lambda: ssd_ops.ssd_scan(*a, chunk=Q))
    return dict(row, device_ms_by_rows=by_rows)


def check_flash_cases(cases, gen, worst, tag: str) -> None:
    """Flash against its plain version on random inputs, bf16 and f32, over
    ``cases`` of (B, S, H, KV, d, window), causal, Sq = Skv."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    for B, S, H, KV, d, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, S, H, d), generator=gen, device=DEV).to(dtype)
            k = torch.randn((B, S, KV, d), generator=gen, device=DEV).to(dtype)
            v = torch.randn((B, S, KV, d), generator=gen, device=DEV).to(dtype)
            out = flash_ops.attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=True, window=window).transpose(1, 2)
            err, ok = max_err(out, ref, TOL[("flash", dtype)])
            del q, k, v, ref, out
            torch.cuda.empty_cache()
            worst["flash_attention"] = max(worst["flash_attention"], err)
            what = f"B={B} S={S} H={H} KV={KV} d={d} window={window}"
            log(f"[{tag}] flash_attention {str(dtype)[6:]} {what}: max_abs_err={err:.3e}")
            check(ok, f"flash_attention {dtype} {what} disagrees with its plain version")


def time_flash(B, S, H, KV, d, gen, window: int = 0):
    """Kernel, plain version, SDPA and bound at (B, S=Sq=Skv), causal, bf16;
    with a window SDPA takes the same visibility as a boolean mask."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dtype = torch.bfloat16
    q = torch.randn((B, S, H, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((B, S, KV, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((B, S, KV, d), generator=gen, device=DEV).to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    def kernel():
        return flash_ops.attention(q, k, v, causal=True, window=window)

    mask = None
    if window:
        pos = torch.arange(S, device=DEV)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=not window, enable_gqa=True)
    ms = cuda_ms(kernel)
    plain = cuda_ms(lambda: attention_ref(qt, kt, vt, causal=True, window=window),
                    iters=5 if S > 1024 else 20)
    lib = cuda_ms(sdpa)
    b_ms, b_by = bound(*flash_ops.work(B, S, S, H, KV, d, window, 2), dtype)
    return dict(shape=f"B={B} S={S} H={H} KV={KV} d={d} window={window}", ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                device_ms=device_ms(kernel), library_device_ms=device_ms(sdpa))


def check_paged(H, KV, d, gen, worst):
    """Paged decode against its plain version in bf16 and f32: B=8, bs=16,
    max_blk=64, ctx 0 / 1 / 17 / 300 / 1024, -1 tails in every table."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    B, bs, max_blk = PAGED_BATCH
    for dtype in (torch.bfloat16, torch.float32):
        args = paged_inputs(B, H, KV, d, bs, max_blk, PAGED_CTX, dtype, gen)
        out = paged_ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        ref = paged_attention_ref(*args)
        err, ok = max_err(out, ref, TOL[("paged", dtype)])
        worst["paged_attention"] = max(worst["paged_attention"], err)
        log(f"[kernels] paged_attention {str(dtype)[6:]} B={B} H={H} KV={KV} "
            f"d={d} bs={bs} ctx={PAGED_CTX}: max_abs_err={err:.3e}")
        check(ok, f"paged_attention {dtype} H={H} KV={KV} d={d} disagrees with "
                  "its plain version")
        check(bool((out[0] == 0).all()), "paged_attention: ctx=0 row is not 0")


def time_paged(H, KV, d, gen, by_uniform_ctx: bool):
    """Kernel, plain version and bound at the decode step's shape, bf16;
    fails unless a call is one kernel.  ``by_uniform_ctx``: device time also
    with every row at one context length, what the live splits cost, from
    one split (ctx <= 64) to sixteen."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    dtype = torch.bfloat16
    B, bs, max_blk = PAGED_BATCH
    args = paged_inputs(B, H, KV, d, bs, max_blk, PAGED_CTX, dtype, gen)
    def paged():
        return paged_ops.paged_decode_attention(*args)
    ms = cuda_ms(paged)
    plain = cuda_ms(lambda: paged_attention_ref(*args), iters=20)
    b_ms, b_by = bound(*paged_ops.work(B, H, KV, d, max_blk, PAGED_CTX, 2), dtype)
    dev, names = device_profile(paged)
    check(len(names) == 1, f"paged_attention: {len(names)} kernels per call: {names}")
    row = dict(shape=f"B={B} H={H} KV={KV} d={d} bs={bs} max_blk={max_blk} "
                     f"ctx={PAGED_CTX}", ms=ms, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, device_ms=dev, device_kernels=names)
    if by_uniform_ctx:
        by_ctx = {}
        for c in (1, 64, 300, 1024):
            a = paged_inputs(B, H, KV, d, bs, max_blk, [c] * B, dtype, gen)
            by_ctx[c] = device_ms(lambda: paged_ops.paged_decode_attention(*a))
        row["device_ms_by_uniform_ctx"] = by_ctx
    return row


def phase_kernels():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = {"paged_attention": 0.0, "flash_attention": 0.0, "ssd_scan": 0.0}
    for H, KV, d in (QWEN_HEADS, MOE_HEADS):
        check_paged(H, KV, d, gen, worst)

    # flash: B=4, Sq=Skv in {32, 128, 200}, Skv > Sq, window 64 at qwen2's
    # heads, Sq=Skv in {128, 200} at qwen3-moe's, then the tests' cases
    # (tests/torch_kernel_cases.py: the reference's sweep and the tiles'
    # edges) and a strided q
    from torch_kernel_cases import (FLASH_CASES, FLASH_STRIDED_Q, flash_inputs,
                                    strided_view)
    Bf = 4
    cases = [(Bf, Sq, Skv, *QWEN_HEADS, w, False) for Sq, Skv, w in
             [(32, 32, 0), (128, 128, 0), (200, 200, 0), (100, 260, 0), (200, 200, 64)]]
    cases += [(Bf, S, S, *MOE_HEADS, 0, False) for S in (128, 200)]
    cases += [(*c, False) for c in FLASH_CASES] + [(*FLASH_STRIDED_Q, True)]
    for dtype in (torch.bfloat16, torch.float32):
        for B_, Sq, Skv, H_, KV_, d_, window, strided in cases:
            q, k, v = (torch.from_numpy(x).to(DEV, dtype)
                       for x in flash_inputs(B_, Sq, Skv, H_, KV_, d_, seed=Sq + d_))
            out = flash_ops.attention(strided_view(q) if strided else q, k, v,
                                      causal=True, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window).transpose(1, 2)
            err, ok = max_err(out, ref, TOL[("flash", dtype)])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            what = (f"B={B_} Sq={Sq} Skv={Skv} H={H_} KV={KV_} d={d_} "
                    f"window={window}{' strided q' if strided else ''}")
            log(f"[kernels] flash_attention {str(dtype)[6:]} {what}: max_abs_err={err:.3e}")
            check(ok, f"flash_attention {dtype} {what} disagrees with its plain version")

    # timings at the serving paths' shapes, bf16
    rows = {"paged_attention": time_paged(*QWEN_HEADS, gen, by_uniform_ctx=True)}
    rows["paged_attention"]["qwen3_moe"] = time_paged(*MOE_HEADS, gen,
                                                      by_uniform_ctx=False)
    rows["flash_attention"] = time_flash(Bf, 128, *QWEN_HEADS, gen)
    rows["flash_attention"].update(
        {f"long_{key}": val for key, val in
         time_flash(*FLASH_LONG, *QWEN_HEADS, gen).items()})
    rows["flash_attention"]["qwen3_moe"] = time_flash(Bf, 128, *MOE_HEADS, gen)
    rows["ssd_scan"] = check_ssd(worst)
    for name, r in rows.items():
        r["max_abs_err"] = worst[name]
        log(f"[kernels] {name} timing bf16: " + json.dumps(r))
    return rows


# --------------------------------------------------------------- phase 3
def serve_traffic(vocab: int):
    """About 10 requests, prompts of 12..400 tokens; four share a 64-token
    prefix; 32 new tokens each; one samples with temperature 0.7 / top-k 40.
    Wave 2 starts after wave 1, so it can hit the prefix cache."""
    rng = np.random.default_rng(SEED)

    def toks(n):
        return [int(x) for x in rng.integers(0, vocab, n)]

    prefix = toks(64)
    wave1 = [toks(12), prefix + toks(20), toks(200), toks(45), toks(400),
             toks(128)]
    wave2 = [prefix + toks(50), prefix + toks(100), prefix + toks(8), toks(30)]
    return wave1, wave2


def mamba_traffic(vocab: int):
    """10 requests, prompts of 12..700 tokens: four of 257..512 (bucket 512,
    two scan chunks), one of 700 (chunked while other rows decode), and two
    that wait for rows that finished requests free; 32 new tokens each, one
    sampled with temperature 0.7 / top-k 40."""
    rng = np.random.default_rng(SEED + 2)
    lens = [12, 300, 700, 45, 480, 128, 64, 400, 20, 260]
    return [[[int(x) for x in rng.integers(0, vocab, n)] for n in lens]]


def kernel_ops():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"paged_attention": paged_ops, "flash_attention": flash_ops,
            "ssd_scan": ssd_ops}


def group_rows(eng) -> list[tuple[int, int]]:
    """(bucket, rows) of every batched prefill the engine ran, read from its
    tracer: admissions in one step (same time stamp) to one bucket."""
    rows: dict = {}
    for tr in eng.tracer.traces():
        for sp in tr.spans:
            kind = sp.attrs.get("kind", "")
            if sp.name == "admission" and kind.startswith("bucket"):
                key = (sp.t0, int(kind[len("bucket"):]))
                rows[key] = rows.get(key, 0) + 1
    return sorted((b, n) for (_, b), n in rows.items())


def bucket_groups(eng) -> list[int]:
    """Bucket of every batched prefill the engine ran."""
    return [b for b, _ in group_rows(eng)]


def serve(cfg, params, backend: str, buckets, waves, max_len: int = 1024, sched=None):
    from repro_torch.models import params as P
    from repro_torch.serving import (CompletionRequest, CompletionsAPI,
                                     InferenceEngine, SchedulerConfig)

    eng = InferenceEngine(cfg, params=params, capacity=8, max_len=max_len,
                          buckets=buckets, block_size=16,
                          sched=sched or SchedulerConfig(),
                          kv_backend=backend, seed=SEED, device=DEV)
    kv_bytes = sum(t.nbytes for t in P.tree_leaves(eng.caches))
    api = CompletionsAPI(eng, model=cfg.name)
    results = []
    ops = kernel_ops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in ops.values():
        m.launches = 0
    t0 = time.perf_counter()
    for w, wave in enumerate(waves):
        streams = []
        for i, prompt in enumerate(wave):
            sampled = w == 0 and i == 3
            creq = CompletionRequest(prompt=prompt, model=cfg.name, max_tokens=32,
                                     temperature=0.7 if sampled else 0.0,
                                     top_k=40 if sampled else 0)
            streams.append((len(prompt), api.stream(creq), [], []))
        active = list(streams)
        while active:
            for s in list(active):
                chunk = next(s[1], None)
                if chunk is None:
                    active.remove(s)
                    continue
                s[2].extend(chunk.choices[0]["tokens"])
                if chunk.choices[0]["finish_reason"] is not None:
                    s[3].append(chunk.choices[0]["finish_reason"])
        results += streams
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: m.launches for name, m in ops.items()}
    hist = eng.history
    decode_steps = sum(1 for st in hist if st.tokens_out)
    tokens = sum(len(r[2]) for r in results)
    stats = dict(
        backend=backend, requests=len(results), steps=len(hist),
        decode_steps=decode_steps, tokens_out=tokens,
        prefill_tokens=sum(st.prefill_tokens for st in hist),
        prefix_hit_tokens=sum(st.prefix_hit_tokens for st in hist),
        wall_s=round(wall, 3),
        prefill_s=round(sum(st.prefill_s for st in hist), 3),
        decode_s=round(sum(st.decode_s for st in hist), 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        kv_pool_bytes=kv_bytes,
        launches=counts, bucket_groups=bucket_groups(eng), group_rows=group_rows(eng),
        chunk_steps=sum(1 for st in hist if st.chunk_rows),
        chunk_steps_with_decode=sum(1 for st in hist
                                    if st.chunk_rows and st.tokens_out))
    log(f"[serve] {cfg.name} {json.dumps(stats)}")
    for n, (plen, _, toks, fin) in enumerate(results):
        check(len(toks) == 32 and fin == ["length"],
              f"{backend}: request {n} (prompt {plen}) got {len(toks)} "
              f"tokens, finish {fin}")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"{backend}: request {n} produced an out-of-vocab token")
    return stats


def check_qwen_serve(cfg, stats, backend: str):
    counts = stats["launches"]
    decode_steps = stats["decode_steps"]
    if backend == "paged":
        check(counts["paged_attention"] >= cfg.num_layers * decode_steps,
              f"paged: {counts['paged_attention']} paged-decode launches for "
              f"{decode_steps} decode steps x {cfg.num_layers} layers")
        check(stats["prefix_hit_tokens"] > 0, "paged: no prefix-cache hits")
    else:
        check(counts["flash_attention"] > 0, "dense: flash attention never ran")
    check(counts["ssd_scan"] == 0, f"{backend}: the SSD scan ran on qwen2")


def check_mamba_serve(cfg, stats):
    counts, groups = stats["launches"], stats["bucket_groups"]
    check(stats["requests"] == 10, f"mamba2: {stats['requests']} requests served")
    check(counts["ssd_scan"] >= cfg.num_layers * len(groups),
          f"mamba2: {counts['ssd_scan']} SSD-scan launches for {len(groups)} "
          f"bucketed prefill groups x {cfg.num_layers} layers")
    check(512 in groups, f"mamba2: no prefill group at bucket 512 ({groups})")
    check(stats["chunk_steps_with_decode"] > 0,
          "mamba2: the chunked prompt never advanced beside decoding rows")
    check(counts["paged_attention"] == 0 and counts["flash_attention"] == 0,
          f"mamba2: attention kernels ran on an attention-free model ({counts})")


def compare_paths(cfg, params, dtype):
    """Kernel path vs use_kernels=False on one prefill + 4 paged decode
    steps, same weights: max |diff| / max |logits| per call.

    In bf16 it also reads two deliberately faulty kernel paths against the
    plain one on the same decode steps (a report, not a check), to show
    whether the bar parts a fault from rounding: the paged kernel given a
    context one token short (the newest key dropped), and one cut to whole
    pages (a partial last page dropped)."""
    import repro_torch.models.lm as lm_mod
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models import params as P
    from repro_torch.models.lm import LM

    if dtype == torch.float32:
        params = P.tree_map(lambda t: t.float(), params)
    kernel = LM(cfg, with_overrides(BASELINE, use_kernels=True))
    models = {"kernel": kernel,
              "plain": LM(cfg, with_overrides(BASELINE, use_kernels=False))}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, S, bs = 4, 128, 16
    faults = {}
    if dtype == torch.bfloat16:
        faults = {"newest_key_dropped": lambda c: (c - 1).clamp(min=0),
                  "partial_page_dropped": lambda c: c // bs * bs}
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    true_len = torch.tensor([128, 100, 77, 12], device=DEV)
    rels = []
    fault_rels = {name: [] for name in faults}
    real_paged = lm_mod.paged_decode_attention

    def decode(name, *args):
        if name not in faults:
            return models[name].decode_step_paged(*args)[0]
        cut = faults[name]
        lm_mod.paged_decode_attention = lambda q, k, v, t, c, **kw: real_paged(
            q, k, v, t, cut(c).to(torch.int32), **kw)
        try:
            return kernel.decode_step_paged(*args)[0]
        finally:
            lm_mod.paged_decode_attention = real_paged

    logits = {n: m.prefill(params, {"tokens": toks}, 256, true_len=true_len)[0]
              for n, m in models.items()}
    rels.append(rel(logits["kernel"], logits["plain"]))

    max_blk = 256 // bs
    table = torch.arange(B * max_blk, dtype=torch.int32,
                         device=DEV).view(B, max_blk)
    pools, last = {}, {}
    for n in [*models, *faults]:
        m = models.get(n, kernel)
        pools[n] = P.init(None, m.paged_cache_specs(B * max_blk, bs), DEV)
        last[n] = m.prefill_chunk_paged(params, toks, torch.zeros(B, dtype=torch.long,
                                                                  device=DEV),
                                        true_len, pools[n], table)[0]
    pos = true_len.clone()
    nxt = last["kernel"].argmax(-1)
    for _ in range(4):
        out = {n: decode(n, params, nxt[:, None], pos, pools[n], table)
               for n in pools}
        rels.append(rel(out["kernel"], out["plain"]))
        for n in faults:
            fault_rels[n].append(rel(out[n], out["plain"]))
        check(bool(torch.isfinite(out["kernel"]).all()), "non-finite logits")
        nxt = out["kernel"].argmax(-1)
        pos = pos + 1
    worst = max(rels)
    log(f"[serve] kernel vs plain logits {str(dtype)[6:]}: rel per call "
        f"{[f'{r:.2e}' for r in rels]} (bar {LOGIT_REL_TOL[dtype]})")
    for n, r in fault_rels.items():
        log(f"[serve] faulty kernel path ({n}) vs plain logits "
            f"{str(dtype)[6:]}: rel per decode step {[f'{x:.2e}' for x in r]}")
    check(worst <= LOGIT_REL_TOL[dtype],
          f"kernel-path logits off by rel {worst:.3e} in {dtype}")


def ssd_path_logits(cfg, params):
    """mamba2 logits per call, in the dtype of ``params``: one prefill at
    S = 512 (two scan chunks; rows of 512, 400, 300 and 12 valid tokens),
    then 4 dense decode steps fed the same drawn tokens whatever the dtype,
    so that calls compare across dtypes.  Three paths: the kernel path, the
    plain path (``use_kernels=False``) and a deliberately faulty kernel path,
    the scan with its inter-chunk carry dropped (the state reset at each
    chunk).  Returns {path: [logits (4, V) f32 per call]}."""
    import repro_torch.models.mamba as mamba_mod
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models.lm import LM

    kernel = LM(cfg, with_overrides(BASELINE, use_kernels=True))
    models = {"kernel": kernel,
              "plain": LM(cfg, with_overrides(BASELINE, use_kernels=False))}
    real_scan = mamba_mod.ssd_scan

    def carry_dropped(x, B, C, dt, da, *, chunk):
        b, S = x.shape[:2]
        n = S // chunk

        def split(t):
            return t.reshape(b * n, chunk, *t.shape[2:])
        y, h = real_scan(*(split(t) for t in (x, B, C, dt, da)), chunk=chunk)
        return y.reshape(b, S, *y.shape[2:]), h.view(b, n, *h.shape[1:])[:, -1]

    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    B, S, steps = 4, 512, 4
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen, device=DEV)
    true_len = torch.tensor([512, 400, 300, 12], device=DEV)
    out = {}
    for n in (*models, "carry_dropped"):
        if n == "carry_dropped":
            mamba_mod.ssd_scan = carry_dropped
        try:
            logits, caches = models.get(n, kernel).prefill(
                params, {"tokens": toks}, S, true_len=true_len)
            out[n] = [logits.float()]
            for i in range(steps):
                out[n].append(models.get(n, kernel).decode_step(
                    params, feed[i], true_len + i, caches)[0].float())
        finally:
            mamba_mod.ssd_scan = real_scan
        check(all(bool(torch.isfinite(t).all()) for t in out[n]),
              f"mamba2: non-finite logits on the {n} path")
    return out


def compare_paths_ssd(cfg, params):
    """mamba2, kernel path against the plain path, same weights: max |diff|
    / max |logits| per call of :func:`ssd_path_logits`.

    f32 is held to its bar at full depth.  In bf16 the plain path rounds M,
    x*dt, C, h and B*wt to bf16 where the kernel keeps f32, and a deep
    random SSM stack amplifies that rounding, so the bf16 bar is held at
    ``MAMBA_BF16_DEPTH`` layers of full width; at full depth each bf16 path
    is read against the f32 plain path instead, and the kernel path must be
    no more than ``MAMBA_BF16_ERR_RATIO`` times as far from it as the plain
    bf16 path.  The carry-dropped fault is reported beside each reading."""
    from repro_torch.models import params as P

    def calls(r):
        return [f"{x:.2e}" for x in r]

    def read(a, b):
        return [rel(x, y) for x, y in zip(a, b)]

    d = min(MAMBA_BF16_DEPTH, cfg.num_layers)
    short = ssd_path_logits(dataclasses.replace(cfg, num_layers=d),
                            dict(params, layers=params["layers"][:d]))
    full = ssd_path_logits(cfg, params)
    f32 = ssd_path_logits(cfg, P.tree_map(lambda t: t.float(), params))
    for what, o, dtype in ((f"{d} layers, bfloat16", short, torch.bfloat16),
                           (f"{cfg.num_layers} layers, bfloat16", full, None),
                           (f"{cfg.num_layers} layers, float32", f32, torch.float32)):
        r = read(o["kernel"], o["plain"])
        bar = f"bar {LOGIT_REL_TOL[dtype]}" if dtype else "read against f32 below"
        log(f"[mamba2] kernel vs plain logits, {what}: rel per call {calls(r)} ({bar})")
        log(f"[mamba2] faulty kernel path (carry_dropped) vs plain logits, "
            f"{what}: rel per call {calls(read(o['carry_dropped'], o['plain']))}")
        check(dtype is None or max(r) <= LOGIT_REL_TOL[dtype],
              f"mamba2 kernel-path logits off by rel {max(r):.3e}, {what}")
    err = {n: read(full[n], f32["plain"]) for n in full}
    log(f"[mamba2] bf16 paths vs the f32 plain path, {cfg.num_layers} layers: "
        f"rel per call kernel {calls(err['kernel'])}, plain {calls(err['plain'])}, "
        f"carry_dropped {calls(err['carry_dropped'])} (bar: kernel <= "
        f"{MAMBA_BF16_ERR_RATIO} x plain)")
    check(max(err["kernel"]) <= MAMBA_BF16_ERR_RATIO * max(err["plain"]),
          f"mamba2 bf16 kernel path is rel {max(err['kernel']):.3e} from the f32 "
          f"plain path, the plain bf16 path {max(err['plain']):.3e}")


def profile_decode(cfg, params, backend: str, buckets, steps: int = 5):
    """Where a decode step's time goes: an engine with 8 rows decoding at
    ~300 tokens of context; wall time per step unprofiled, then device
    time per step by op under torch.profiler (a report, not a check)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import InferenceEngine, Request, SamplingParams
    eng = InferenceEngine(cfg, params=params, capacity=8, max_len=1024,
                          buckets=buckets, block_size=16,
                          kv_backend=backend, seed=SEED, device=DEV)
    rng = np.random.default_rng(SEED + 1)
    for i in range(8):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(0, cfg.vocab_size, 300)],
                           sampling=SamplingParams(max_new_tokens=4 + 2 * steps)))
    while eng._prefilling or eng.scheduler.depth():
        eng.step()
    paged = kernel_ops()["paged_attention"]
    torch.cuda.synchronize()
    n0 = paged.launches
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    paged_per_step = (paged.launches - n0) / steps
    moe = bool(cfg.num_experts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=moe) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    # the device's own entries (kernels, copies): an op's self device time
    # repeats its kernels' time, so summing every entry counts it twice
    dev_ms = sum(dev_us(e) for e in events if on_device(e)) / steps / 1e3
    # by host op: the device time of the kernels each op launched
    top = [(e.key, round(dev_us(e) / steps / 1e3, 4), e.count // steps)
           for e in events if dev_us(e) > 0 and not on_device(e)][:10]
    # the port's own kernels, wherever they rank
    ours = [(re.search(r"\w+_kernel", e.key).group(0), round(dev_us(e) / steps / 1e3, 4),
             e.count // steps)
            for e in events if "repro::" in e.key and dev_us(e) > 0]
    report = {"model": cfg.name, "backend": backend,
              "decode_step_wall_ms": round(wall_ms, 3),
              "decode_step_device_ms": round(dev_ms, 3) if dev_ms else "not measured",
              "device_busy_share": round(dev_ms / wall_ms, 3) if dev_ms else "not measured",
              "port_kernels_ms_per_step_and_calls": ours,
              "paged_launches_per_step": paged_per_step,
              "top_ops_ms_per_step_and_calls": top}
    if moe and dev_ms:
        report["moe"] = moe_step_report(cfg, prof, steps, dev_ms, wall_ms)
    log(f"[profile] {json.dumps(report)}")
    return report


def weight_read_bound_ms(cfg) -> tuple[float, int]:
    """The least time a decode step can take when it reads every weight
    once, at 3.35 TB/s: (ms, bytes).  An untied embedding table is left
    out (the step gathers a few rows of it); a tied one is read whole by
    the unembedding."""
    from repro_torch.models import params as P
    from repro_torch.models.lm import make_model

    specs = make_model(cfg).param_specs()
    nbytes = P.count_bytes(specs)
    if not cfg.tie_embeddings:
        nbytes -= P.count_bytes(specs["embed"]["embedding"])
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def moe_step_report(cfg, prof, steps, dev_ms, wall_ms) -> dict:
    """The MoE decode step by part, ms per step on the device: the expert
    products (every ``bmm`` of a paged decode step is one), the router (the
    ops on its (D, E) weight: its f32 cast and the f32 product), paged
    decode, and the rest; then the step against its weight-read bound."""
    def ms(events):
        # leaf ops and kernels only, by the device time of all they launch
        return round(sum(getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0) for e in events)
                     / steps / 1e3, 4)

    by_shape = list(prof.key_averages(group_by_input_shape=True))
    router_shape = [cfg.d_model, cfg.num_experts]
    expert = [e for e in by_shape if e.key == "aten::bmm"]
    router = [e for e in by_shape if e.key in ("aten::mm", "aten::copy_")
              and router_shape in (e.input_shapes or [])]
    paged = [e for e in by_shape if "paged_decode" in e.key]
    bound_ms, nbytes = weight_read_bound_ms(cfg)
    parts = {"expert_bmm": ms(expert), "router": ms(router), "paged_decode": ms(paged)}
    parts["rest"] = round(dev_ms - sum(parts.values()), 4)
    busy = dev_ms / wall_ms
    return {"device_ms_by_part": parts,
            "device_share_by_part": {k: round(v / dev_ms, 4) for k, v in parts.items()},
            "expert_bmm_calls_per_step": sum(e.count for e in expert) // steps,
            "weight_bytes_read_once": nbytes, "step_bound_ms": round(bound_ms, 3),
            "device_over_bound": round(dev_ms / bound_ms, 3),
            "wall_over_bound": round(wall_ms / bound_ms, 3),
            "step_set_by": "the card" if busy >= 0.9 else "the host"}


def load_model(arch: str, num_layers: int | None = None):
    """An arch's published config, cut to ``num_layers`` where given, and
    its random weights drawn on the card from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as P
    from repro_torch.models.lm import make_model

    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    specs = make_model(cfg).param_specs()
    log(f"[serve] {cfg.name}: {P.count_params(specs) / 1e6:.1f}M params, "
        f"{P.count_bytes(specs) / 1e9:.3f} GB")
    return cfg, P.init(torch.Generator(device=DEV).manual_seed(SEED), specs, DEV)


def phase_qwen():
    cfg, params = load_model(QWEN)
    buckets = (32, 64, 128)
    stats = {}
    for b in ("paged", "dense"):
        stats[b] = serve(cfg, params, b, buckets, serve_traffic(cfg.vocab_size))
        check_qwen_serve(cfg, stats[b], b)
    stats["decode_profile"] = profile_decode(cfg, params, "paged", buckets)
    compare_paths(cfg, params, torch.bfloat16)
    compare_paths(cfg, params, torch.float32)
    return stats


def phase_mamba():
    cfg, params = load_model(MAMBA)
    buckets = (64, 256, 512)
    stats = serve(cfg, params, "dense", buckets, mamba_traffic(cfg.vocab_size))
    check_mamba_serve(cfg, stats)
    profile_decode(cfg, params, "dense", buckets)
    compare_paths_ssd(cfg, params)
    return stats


# ---------------------------------------------------------------- cluster
CLUSTER_ENGINE = dict(capacity=8, max_len=1024, block_size=16,
                      buckets=(32, 64, 128))
CLUSTER_MAX_REPLICAS = 3
CLUSTER_LINK_BLOCKS = 4       # KV blocks a transport link carries per step
CLUSTER_NEW_TOKENS = 32
CLUSTER_PROFILE_STEPS = 4     # steps at full scale under torch.profiler


def cluster_traffic(vocab: int):
    """24 requests of 32 new tokens, prompts of 8..400 tokens, a third of
    them opening with one 64-token prefix.  A burst of 18 arrives two a step
    over the first 9 steps; a quiet tail of 6 follows from step 34, one
    every 3 steps.  The fourth request samples (temperature 0.7, top-k 40),
    the rest are greedy.  Returns ({step: [(rid, prompt)]}, prefix)."""
    rng = np.random.default_rng(SEED + 3)

    def toks(n):
        return [int(x) for x in rng.integers(0, vocab, n)]

    prefix = toks(64)
    burst = [300, 12, 45, 200, 400, 80, 128, 20, 350, 96, 150, 30, 250, 100,
             16, 180, 60, 320]
    tail = [(True, 20), (False, 40), (True, 100), (False, 12), (False, 8),
            (False, 90)]
    out: dict[int, list] = {}
    for i, n in enumerate(burst):
        p = prefix + toks(n - 64) if i % 3 == 0 else toks(n)
        out.setdefault(i // 2, []).append((i, p))
    for j, (shared, n) in enumerate(tail):
        p = prefix + toks(n) if shared else toks(n)
        out.setdefault(34 + 3 * j, []).append((100 + j, p))
    return out, prefix


class MigrationProbe:
    """Observes a replica's side of every migration: CUDA events around
    ``extract_row``, each ``feed_adopt`` and ``commit_adopt``, and the
    paged-decode launches of every step in which a row this replica adopted
    is decoding.  It wraps the engine's public methods and changes nothing
    they do."""

    def __init__(self, ops):
        self.ops = ops
        self.moves: dict[int, list[dict]] = {}     # rid -> its moves, in order
        self.adopted_steps: list[int] = []         # launches per such step
        self._tickets: dict[tuple[int, int], int] = {}

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wrap(self, eng):
        extract, begin, feed = eng.extract_row, eng.begin_adopt, eng.feed_adopt
        commit, step = eng.commit_adopt, eng.step
        adopted: set[int] = set()

        def extract_row(rid, now=None):
            e0 = self._event()
            req, payload = extract(rid, now)
            self.moves.setdefault(rid, []).append(
                {"extract": (e0, self._event()), "feed": [],
                 "blocks": payload.get("n_blocks", 0)})
            return req, payload

        def begin_adopt(req, payload, now=None):
            ticket = begin(req, payload, now)
            if ticket is not None:
                self._tickets[(id(eng), ticket)] = req.rid
            return ticket

        def feed_adopt(ticket, index, data):
            e0 = self._event()
            feed(ticket, index, data)
            rid = self._tickets[(id(eng), ticket)]
            self.moves[rid][-1]["feed"].append((e0, self._event()))

        def commit_adopt(ticket, now=None):
            rid = self._tickets.pop((id(eng), ticket))
            e0 = self._event()
            req = commit(ticket, now)
            self.moves[rid][-1]["commit"] = (e0, self._event())
            adopted.add(rid)
            return req

        def step_(now=None):
            live = adopted & {r.rid for r in eng.row_req.values()}
            n0 = self.ops.launches
            st = step(now)
            if live:
                self.adopted_steps.append(self.ops.launches - n0)
            return st

        eng.extract_row, eng.begin_adopt, eng.feed_adopt = (
            extract_row, begin_adopt, feed_adopt)
        eng.commit_adopt, eng.step = commit_adopt, step_
        return eng

    def report(self, events) -> list[dict]:
        """One row per completed migration event: blocks, bytes, and the
        extract, transfer (extract end to commit start, both replicas
        stepping meanwhile) and adopt (every chunk's scatter and the
        commit) times in ms on the card's timeline."""
        seen: dict[int, int] = {}
        rows = []
        for ev in events:
            k = seen.get(ev.rid, 0)
            seen[ev.rid] = k + 1
            mv = self.moves[ev.rid][k]
            (x0, x1), (c0, c1) = mv["extract"], mv["commit"]
            rows.append({
                "rid": ev.rid, "src": ev.src, "dst": ev.dst, "phase": ev.phase,
                "blocks": mv["blocks"], "chunks": ev.chunks,
                "blocks_skipped": ev.blocks_skipped, "bytes": ev.bytes,
                "bytes_full": ev.bytes_full, "transport_steps": ev.duration_s,
                "extract_ms": round(x0.elapsed_time(x1), 4),
                "transfer_ms": round(x1.elapsed_time(c0), 4),
                "adopt_ms": round(sum(a.elapsed_time(b) for a, b in mv["feed"])
                                  + c0.elapsed_time(c1), 4)})
        return rows


def cluster_engine_factory(cfg, params):
    from repro_torch.serving import InferenceEngine

    return lambda: InferenceEngine(cfg, params=params, kv_backend="paged",
                                   seed=SEED, device=DEV, **CLUSTER_ENGINE)


def check_gapless(events, done) -> None:
    """Every request's token events carry indices 0, 1, ... with no gap or
    repeat, however many replicas served it, and match its output."""
    from repro_torch.serving import FirstTokenEvent, TokenEvent

    idx: dict[int, list[int]] = {}
    for e in events:
        if isinstance(e, (FirstTokenEvent, TokenEvent)):
            idx.setdefault(e.rid, []).append(e.index)
    for r in done:
        got = idx.get(r.rid, [])
        check(got == list(range(len(r.output))),
              f"cluster: rid {r.rid} ({r.migrations} migrations) has token "
              f"event indices {got[:40]} for {len(r.output)} tokens")


def run_cluster(cfg, params):
    """The cluster trace through an ``EndpointRegistry`` of paged qwen2
    replicas sharing one weight tree.  Returns the registry, its one
    orchestrator, the probe, (replicas, wall s) of every step outside the
    profiled window, the window's (wall s, busy s) and the event stream."""
    from repro_torch.core import EndpointRegistry, HPAConfig, ModelEndpoint
    from repro_torch.core.transport import LinkSpec, Transport
    from repro_torch.serving import Request, SamplingParams

    kops = kernel_ops()
    ops = kops["paged_attention"]
    probe = MigrationProbe(ops)
    make = cluster_engine_factory(cfg, params)
    # one KV block of every layer: bf16 K and V
    block_bytes = (2 * cfg.num_layers * CLUSTER_ENGINE["block_size"]
                   * cfg.num_kv_heads * cfg.head_dim * 2)
    reg = EndpointRegistry(
        [ModelEndpoint(
            name=cfg.name, make_engine=lambda: probe.wrap(make()),
            kv_backend="paged", max_replicas=CLUSTER_MAX_REPLICAS,
            lb_policy="directory", cold_start_steps=0,
            hpa=HPAConfig(metric="queue", target=4.0,
                          max_replicas=CLUSTER_MAX_REPLICAS, tolerance=0.0,
                          stabilization_s=8.0, scale_down_cooldown_s=8.0))],
        transport=Transport(LinkSpec(
            latency_steps=1, bandwidth=CLUSTER_LINK_BLOCKS * block_bytes)))
    orch = reg.resolve(cfg.name)
    arrivals, prefix = cluster_traffic(cfg.vocab_size)
    reqs, steps, events = [], [], []
    prof_steps = []
    t = 0
    for m in kops.values():
        m.launches = 0
    while t < 600:
        for rid, prompt in arrivals.get(t, []):
            sampled = rid == 3
            req = Request(rid=rid, model=cfg.name, prompt=prompt,
                          sampling=SamplingParams(
                              max_new_tokens=CLUSTER_NEW_TOKENS,
                              temperature=0.7 if sampled else 0.0,
                              top_k=40 if sampled else 0))
            check(reg.submit(req, now=float(t)),
                  f"cluster: request {rid} rejected ({req.state})")
            reqs.append(req)
        if not reg.pending() and t > max(arrivals):
            break
        n_rep = len(orch.engines)
        window = (n_rep == CLUSTER_MAX_REPLICAS
                  and len(prof_steps) < CLUSTER_PROFILE_STEPS)
        if window:
            prof_steps.append(cluster_profiled_step(reg, t))
        else:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            reg.step(float(t))
            torch.cuda.synchronize()
            steps.append((n_rep, time.perf_counter() - w0))
        events += reg.drain_events()
        t += 1
    return dict(reg=reg, orch=orch, probe=probe, reqs=reqs, prefix=prefix,
                steps=steps, prof=prof_steps, events=events, n_steps=t,
                launches={name: m.launches for name, m in kops.items()})


def cluster_profiled_step(reg, t) -> tuple[float, float]:
    """One cluster step under torch.profiler: (wall s, device busy s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        reg.step(float(t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    busy = sum(dev_us(e) for e in prof.key_averages()) / 1e6
    return wall, busy


def cluster_round_trip(cfg, params):
    """Extract a live decode row on replica A and adopt it directly on
    replica B, whose prefix cache is empty: B's blocks must hold the
    payload bit for bit, and the row's greedy tokens must equal the same
    request decoded unmigrated.  Then the device time of the payload's
    gather and scatter beside their bound.  Returns a report."""
    from repro_torch.serving import Request, SamplingParams

    make = cluster_engine_factory(cfg, params)
    prompt = [int(x) for x in
              np.random.default_rng(SEED + 4).integers(0, cfg.vocab_size, 300)]

    def request():
        return Request(rid=0, prompt=list(prompt), sampling=SamplingParams(
            max_new_tokens=CLUSTER_NEW_TOKENS))

    def finish(eng, t):
        while eng.pending():
            eng.step(float(t))
            t += 1
        return list(eng.finished[0].output)

    ref = make()
    ref.submit(request(), now=0.0)
    want = finish(ref, 0)
    a, b = make(), make()
    a.submit(request(), now=0.0)
    t = 0
    while len(a.row_req) == 0 or len(next(iter(a.row_req.values())).output) < 8:
        a.step(float(t))
        t += 1
    check(b.prefix.cached_blocks == 0 and b.prefix.used_blocks == 0,
          "round trip: B's prefix cache is not empty")
    torch.cuda.synchronize()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    req, payload = a.extract_row(0, now=float(t))
    e[1].record()
    check(b.adopt(req, payload, now=float(t)), "round trip: B refused the row")
    e[2].record()
    torch.cuda.synchronize()
    ids = list(b._row_blocks[req.row][: payload["n_blocks"]])
    held = b._gather_blocks(ids)
    for i, (got, sent) in enumerate(zip(held, payload["blocks"])):
        for n in sent:
            check(torch.equal(got[n], sent[n]),
                  f"round trip: layer {i} {n} differs from the payload on B")
    got = finish(b, t)
    check(got == want, f"round trip: migrated tokens {got} differ from the "
          f"unmigrated {want}")
    nbytes = sum(x.nbytes for layer in payload["blocks"] for x in layer.values())
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    return {"blocks": payload["n_blocks"], "bytes": nbytes,
            "pos": payload["pos"], "tokens_before_move": 8,
            "extract_ms": round(e[0].elapsed_time(e[1]), 4),
            "adopt_ms": round(e[1].elapsed_time(e[2]), 4),
            "gather_device_ms": round(device_ms(lambda: b._gather_blocks(ids)), 5),
            "gather_events_ms": round(cuda_ms(lambda: b._gather_blocks(ids)), 5),
            "scatter_device_ms": round(device_ms(
                lambda: b._scatter_blocks(payload["blocks"], ids, 0)), 5),
            "scatter_events_ms": round(cuda_ms(
                lambda: b._scatter_blocks(payload["blocks"], ids, 0)), 5),
            "bound_ms": round(bound_ms, 6), "bound_by": "bytes"}


def check_cluster(cfg, run) -> dict:
    from repro_torch.serving import State

    reg, orch, probe, reqs = run["reg"], run["orch"], run["probe"], run["reqs"]
    done = reg.finished()
    check(len(done) == len(reqs) == 24, f"cluster: {len(done)} of {len(reqs)} "
          "requests finished")
    for r in reqs:
        check(r.state is State.DONE and len(r.output) == CLUSTER_NEW_TOKENS
              and all(0 <= x < cfg.vocab_size for x in r.output),
              f"cluster: request {r.rid} ended {r.state} with "
              f"{len(r.output)} tokens")
    counts = [1] + [n for _, n in orch.scale_history]
    ups = sum(1 for a, b in zip(counts, counts[1:]) if b > a)
    downs = sum(1 for a, b in zip(counts, counts[1:]) if b < a)
    check(ups >= 1, f"cluster: no scale-up ({orch.scale_history})")
    migs = orch.migrations.events
    decode_moves = [e for e in migs if e.phase == "decode"]
    check(decode_moves, f"cluster: no async decode-phase migration ({migs})")
    stats = orch.directory.stats
    shared = [r for r in done if r.prompt[:64] == run["prefix"]]
    hits = sum(r.prefix_hit_tokens for r in shared)
    check(stats.lookup_hit_tokens > 0 and hits > 0,
          f"cluster: no directory-routed prefix hit (directory lookups "
          f"{stats.lookups}, overlap tokens {stats.lookup_hit_tokens}, "
          f"cached tokens on the shared prefix {hits})")
    check(run["launches"]["flash_attention"] == 0
          and run["launches"]["ssd_scan"] == 0,
          f"cluster: a prefill kernel ran on the paged path ({run['launches']})")
    check(any(n >= cfg.num_layers for n in probe.adopted_steps),
          f"cluster: paged decode never launched on a replica after it "
          f"adopted a row ({probe.adopted_steps[:8]})")
    check_gapless(run["events"], done)
    return {"requests": len(done), "steps": run["n_steps"],
            "scale_history": orch.scale_history, "scale_ups": ups,
            "scale_downs": downs, "migrations": len(migs),
            "decode_phase_migrations": len(decode_moves),
            "migration_failures": len(orch.migrations.failures),
            "directory": dataclasses.asdict(stats),
            "shared_prefix_hit_tokens": hits,
            "launches": run["launches"],
            "steps_with_adopted_rows": len(probe.adopted_steps)}


def phase_cluster():
    cfg, params = load_model(QWEN)
    t0 = time.perf_counter()
    trip = cluster_round_trip(cfg, params)
    log(f"[cluster] round trip {json.dumps(trip)}")
    run = run_cluster(cfg, params)
    summary = check_cluster(cfg, run)
    for row in run["probe"].report(run["orch"].migrations.events):
        log(f"[cluster] migration {json.dumps(row)}")
    by_rep: dict[int, list[float]] = {}
    for n, wall in run["steps"]:
        by_rep.setdefault(n, []).append(wall)
    wall = sum(w for _, w in run["steps"]) + sum(w for w, _ in run["prof"])
    tokens = sum(len(r.output) for r in run["reqs"])
    summary.update(
        step_wall_ms_by_replicas={n: {"steps": len(w),
                                      "mean": round(1e3 * sum(w) / len(w), 3),
                                      "max": round(1e3 * max(w), 3)}
                                  for n, w in sorted(by_rep.items())},
        profiled_steps=[{"wall_ms": round(1e3 * w, 3),
                         "device_busy_ms": round(1e3 * b, 3)}
                        for w, b in run["prof"]],
        device_busy_share=(round(sum(b for _, b in run["prof"])
                                 / sum(w for w, _ in run["prof"]), 4)
                           if run["prof"] else "not measured"),
        served_tokens=tokens, serve_wall_s=round(wall, 3),
        served_tokens_per_s=round(tokens / wall, 2),
        phase_s=round(time.perf_counter() - t0, 1))
    log(f"[cluster] {json.dumps(summary)}")
    log(f"[cluster] {gpu_line()}")
    return summary


# ----------------------------------------------------------------- stages
STAGE_PROMPTS = (12, 40, 64, 100, 180, 256, 300, 400)   # one bucket-512 group
STAGE_BUCKET = 512
STAGE_MAX_LEN = 1024
STAGE_COUNTS = (1, 2, 4, 24)  # 24: the paper's one microservice a layer
STAGE_SPLIT = 4               # stages of the split check, stage 0 on 2 replicas
STAGE_STEPS = 10              # timed decode steps of each pipeline
GEMMA_STAGE_PROMPTS = (1100, 700, 300, 12)   # the first past the ring of 1024
GEMMA_STAGE_COUNTS = (2, 5)   # gemma3-4b: 5 groups of 6, 4 tail layers on the last


def clone_caches(caches) -> list:
    return [{k: t.clone() for k, t in c.items()} for c in caches]


def staged_prefill(cfg, params, lens, bucket: int, max_len: int, seed: int):
    """Right-padded prompts of ``lens`` tokens as one bucketed prefill group
    through ``LM.prefill`` (flash on every attention layer): (model, the
    next tokens (B, 1), their positions, the per-layer caches)."""
    from repro_torch.models.lm import LM

    m = LM(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (len(lens), bucket), generator=gen, device=DEV)
    true_len = torch.tensor(lens, device=DEV)
    logits, caches = m.prefill(params, {"tokens": toks}, max_len, true_len=true_len)
    return m, logits.argmax(-1)[:, None], true_len, caches


def check_staged_bitwise(m, params, tok, pos, caches, counts, tag: str) -> dict:
    """One decode step through ``StagePipeline`` at each stage count, each
    from a copy of ``caches``: logits equal the monolithic ``decode_step``'s
    bit for bit (the same ops on the same shapes), and so do the caches."""
    from repro_torch.core import StagePipeline

    mono_caches = clone_caches(caches)
    mono, _ = m.decode_step(params, tok, pos, mono_caches)
    out = {}
    for n in counts:
        pipe = StagePipeline(m, params, n)
        got, got_caches = pipe.decode_step(tok, pos, clone_caches(caches), now=0.0)
        same = torch.equal(got, mono) and all(
            torch.equal(a[k], b[k]) for a, b in zip(got_caches, mono_caches) for k in a)
        out[n] = {"layer_bounds": pipe.staged.layer_bounds, "bit_equal": same}
        check(same, f"[{tag}] {m.cfg.name}: a decode step at {n} stages differs from the "
              f"monolithic step (max |d| {float((got - mono).abs().max()):.3e})")
    log(f"[{tag}] {m.cfg.name}: staged decode bit-equal to the monolithic step at "
        f"{list(counts)} stages; layer bounds "
        f"{json.dumps({n: o['layer_bounds'] for n, o in out.items()})}")
    return out


def time_decode(step, tok, pos, caches, now0: float = 0.0, after_warm=None) -> list[float]:
    """Wall ms of ``STAGE_STEPS`` synchronised decode steps after one warm
    step (then ``after_warm()``), from a copy of ``caches``, positions
    advancing."""
    c = clone_caches(caches)
    step(tok, pos, c, now0)
    torch.cuda.synchronize()
    if after_warm:
        after_warm()
    walls = []
    for i in range(STAGE_STEPS):
        t0 = time.perf_counter()
        step(tok, pos + 1 + i, c, now0 + 1 + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def profiled_busy(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms and the device's
    busy ms (its kernels and copies summed) and share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(dev_us(e) for e in prof.key_averages()) / 1e3
    return {"wall_ms": round(wall, 3), "device_busy_ms": round(busy, 3) if busy else "not measured",
            "busy_share": round(busy / wall, 4) if busy else "not measured"}


def phase_stages():
    """The paper's stage microservices on the card (``core.microservice``):
    qwen2-0.5b whole (24 layers, bf16, seed-0 weights), 8 prompts of 12 to
    400 tokens prefilled as one bucket-512 group through ``LM.prefill``
    (exactly 24 flash launches), then the decode step through
    ``StagePipeline`` at 1, 2, 4 and 24 stages, bit-equal to the monolithic
    ``decode_step`` and launching no kernel (dense decode is the plain
    attention); stage 0 of 4 scaled to 2 replicas (rows 4 + 4) within the
    bf16 logit bar; the profiler-to-HPA loop of the reference's
    ``tests/test_engine.py`` (rank ``stage/<i>``, size the hot stage by the
    latency HPA, scale it); the step walls beside the monolithic one, the
    per-stage ms by CUDA events and a profiled step's device busy share."""
    from repro_torch.core import Autoscaler, HPAConfig, Profiler, StagePipeline

    t0 = time.perf_counter()
    cfg, params = load_model(QWEN)
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    m, tok, pos, caches = staged_prefill(cfg, params, STAGE_PROMPTS, STAGE_BUCKET,
                                         STAGE_MAX_LEN, SEED + 21)
    torch.cuda.synchronize()
    prefill = {name: op.launches for name, op in ops.items()}
    check(prefill == {"paged_attention": 0, "flash_attention": cfg.num_layers, "ssd_scan": 0},
          f"[stages] {cfg.name}: a prefill group launched {prefill}")
    bitwise = check_staged_bitwise(m, params, tok, pos, caches, STAGE_COUNTS, "stages")
    torch.cuda.synchronize()
    launches = {name: op.launches for name, op in ops.items()}
    decode = {name: launches[name] - prefill[name] for name in launches}
    check(not any(decode.values()), f"[stages] staged decode launched kernels: {decode}")

    mono_walls = time_decode(lambda t, p, c, now: m.decode_step(params, t, p, c),
                             tok, pos, caches)
    out = {"prompts": list(STAGE_PROMPTS), "prefill_launches": prefill,
           "decode_launches": decode, "bit_equal": bitwise,
           "monolithic_step_wall_ms": round(float(np.median(mono_walls)), 3),
           "staged": {}}
    for n in STAGE_COUNTS:
        pipe = StagePipeline(m, params, n)
        walls = time_decode(lambda t, p, c, now: pipe.decode_step(t, p, c, now=now),
                            tok, pos, caches,
                            after_warm=lambda: setattr(pipe, "profiler", Profiler()))
        now = float(STAGE_STEPS)
        stage_ms = [pipe.profiler.latency[f"stage/{i}"].mean(now) * 1e3
                    for i in range(pipe.staged.num_stages)]
        ranked = pipe.profiler.bottlenecks("stage/", now=now)
        out["staged"][n] = {
            "step_wall_ms": round(float(np.median(walls)), 3),
            "stage_ms_sum": round(sum(stage_ms), 3),
            "stage_ms_mean": [round(x, 4) for x in stage_ms],
            "ranking_by_max_ms": [(name, round(v * 1e3, 4)) for name, v in ranked[:5]]}
        log(f"[stages] {n} stages: {json.dumps(out['staged'][n])}")

    # a split stage: stage 0 of 4 on 2 replicas, rows 4 + 4
    mono, _ = m.decode_step(params, tok, pos, clone_caches(caches))
    pipe = StagePipeline(m, params, STAGE_SPLIT)
    pipe.scale_stage(0, 2, now=0.0)
    got, _ = pipe.decode_step(tok, pos, clone_caches(caches), now=0.0)
    split_rel = rel(got.float(), mono.float())
    check(split_rel <= LOGIT_REL_TOL[torch.bfloat16],
          f"[stages] stage 0 on 2 replicas: logits rel {split_rel:.3e} from the monolithic step")
    walls = time_decode(lambda t, p, c, now: pipe.decode_step(t, p, c, now=now),
                        tok, pos, caches)
    out["split"] = {"stages": STAGE_SPLIT, "stage0_replicas": 2, "rows": [4, 4],
                    "logits_rel": split_rel,
                    "step_wall_ms": round(float(np.median(walls)), 3)}

    # the profiler-to-HPA loop (tests/test_engine.py::test_stage_profiler_drives_hpa)
    pipe = StagePipeline(m, params, cfg.num_layers)
    c = clone_caches(caches)
    for i in range(3):
        pipe.decode_step(tok, pos + i, c, now=float(i))
    ranked = pipe.profiler.bottlenecks("stage/")
    hot = int(ranked[0][0].split("/")[1])
    hpa = Autoscaler(HPAConfig(metric="latency", target=ranked[0][1] / 2,
                               tolerance=0.0, max_replicas=4))
    new = hpa.evaluate(3.0, 1, ranked[0][1])
    check(new >= 2, f"[stages] the HPA sized the hot stage {hot} at {new} replicas")
    pipe.scale_stage(hot, new, now=3.0)
    check(len(pipe.replicas[hot]) == new, "[stages] the hot stage was not scaled")
    logits, _ = pipe.decode_step(tok, pos + 3, c, now=4.0)
    check(bool(torch.isfinite(logits).all()), "[stages] non-finite logits after scaling")
    out["hpa"] = {"hot_stage": hot, "hot_max_ms": round(ranked[0][1] * 1e3, 4),
                  "replicas": new}

    pipe = StagePipeline(m, params, cfg.num_layers)
    c, mc = clone_caches(caches), clone_caches(caches)
    out["profiled"] = {
        "staged_24": profiled_busy(lambda: pipe.decode_step(tok, pos, c, now=0.0)),
        "monolithic": profiled_busy(lambda: m.decode_step(params, tok, pos, mc))}
    del params, caches, c, mc, pipe, m
    release()
    out.update(launches=launches, phase_s=round(time.perf_counter() - t0, 1))
    log(f"[stages] {json.dumps({k: out[k] for k in ('monolithic_step_wall_ms', 'split', 'hpa', 'profiled', 'launches', 'phase_s')})}")
    log(f"[stages] {gpu_line()}")
    return out


# --------------------------------------------------------------- examples
EXAMPLES = (("quickstart", "served 5/5 requests"), ("serve_autoscaling", "completed 16/16"),
            ("elastic_failover", "completed to step 15"), ("train_tiny", "loss: "))


def phase_examples() -> dict:
    """The port's four examples (``python -m repro_torch.examples.<name>``)
    as subprocesses on the card at their smoke sizes, all four at once:
    each must exit 0 and print its summary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        procs = {}
        try:
            for name, _ in EXAMPLES:
                args = ["--ckpt-dir", str(Path(tmp) / "ckpt")] if name == "train_tiny" else []
                f = open(Path(tmp) / f"{name}.log", "w")
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                    stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT), f)
            for name, (p, f) in procs.items():
                rc = p.wait(timeout=300)
                f.close()
                text = (Path(tmp) / f"{name}.log").read_text()
                out[name] = {"rc": rc, "s": round(time.perf_counter() - t0, 1),
                             "last_line": (text.strip().splitlines() or [""])[-1]}
                log(f"[examples] {name}: exit {rc}: {out[name]['last_line']}")
                want = dict(EXAMPLES)[name]
                check(rc == 0 and want in text,
                      f"example {name} failed (exit {rc}): {text[-1500:]}")
        finally:
            for p, f in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                f.close()
    out["phase_s"] = round(time.perf_counter() - t0, 1)
    log(f"[examples] {out['phase_s']} s for the four; {gpu_line()}")
    return out


# ----------------------------------------------------------- gemma family
# weight bytes of the port's specs (bf16 weights, f32 norm scales) of the
# models drawn whole from here on, or at the depth they are served
WEIGHT_BYTES = {"gemma-2b": 5_012_496_384, "gemma3-4b": 7_760_238_592,
                "paligemma-3b": 5_017_477_120, "gemma3-27b": 54_018_046_976,
                "jamba-v0.1-52b": 51_997_155_840,     # 16 of its 32 layers
                "mixtral-8x7b": 58_575_437_824,       # 20 of its 32 layers
                "whisper-small": 529_227_264}
GEMMA2B_HEADS = (8, 1, 256)   # H, KV, head_dim of gemma-2b and paligemma-3b
GEMMA34B_HEADS = (8, 4, 256)  # of gemma3-4b
FAMILY_FLASH = ((8, 1024, *GEMMA2B_HEADS, 0), (4, 2048, *GEMMA34B_HEADS, 1024),
                (4, 2048, *GEMMA34B_HEADS, 0))   # B, S, H, KV, d, window
PALI_BUCKETS = (64, 256, 512)
PALI_MAX_LEN = 1024
PALI_PROMPTS = (12, 40, 64, 100, 180, 256, 300, 400, 480, 500)
PALI_PATCH_STD = 0.02


def check_kernels_d256(worst) -> dict:
    """Flash and paged decode at head_dim 256 against their plain versions in
    bf16 and f32: flash at gemma-2b's heads (B=8, S=1024, 8 over 1) and
    gemma3-4b's (B=4, S=2048, 8 over 4, windows 1024 and 0), paged decode
    at gemma-2b's decode step (B=8, ``PAGED_CTX``); then each timed in bf16
    beside its bound, flash beside SDPA with the same mask, paged decode
    held to one kernel a call."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    check_flash_cases(FAMILY_FLASH, gen, worst, "family")
    check_paged(*GEMMA2B_HEADS, gen, worst)
    flash = {}
    for B, S, H, KV, d, window in FAMILY_FLASH:
        flash[f"B{B}_S{S}_KV{KV}_window_{window}"] = r = time_flash(
            B, S, H, KV, d, gen, window=window)
        log(f"[family] flash_attention timing bf16: {json.dumps(r)}")
    paged = time_paged(*GEMMA2B_HEADS, gen, by_uniform_ctx=False)
    log(f"[family] paged_attention timing bf16: {json.dumps(paged)}")
    torch.cuda.empty_cache()
    return {"flash": flash, "paged": paged}


class FlashWindows:
    """Tallies the window of every flash call the model makes, by wrapping
    the model's reference to the wrapper (the wrapper's launch count is
    left as it is)."""

    def __enter__(self):
        import repro_torch.models.lm as lm_mod

        self.mod, self.real, self.by_window = lm_mod, lm_mod.flash_attention, {}

        def flash(q, k, v, *, causal=True, window=0, scale=None):
            self.by_window[window] = self.by_window.get(window, 0) + 1
            return self.real(q, k, v, causal=causal, window=window, scale=scale)

        lm_mod.flash_attention = flash
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real


def paged_path_logits(cfg, params, use_kernels: bool) -> list:
    """Logits (f32) of every call, in the dtype of ``params``: a prefill of
    4 right-padded prompts of 128, 100, 77 and 12 tokens (flash on the
    kernel path), a paged chunked prefill of the same prompts, then 4 paged
    decode steps (paged decode on the kernel path) fed the same drawn
    tokens whatever the path."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models import params as P
    from repro_torch.models.lm import LM

    m = LM(cfg, with_overrides(BASELINE, use_kernels=use_kernels))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, S, bs = 4, 128, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    feed = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=gen, device=DEV)
    true_len = torch.tensor([128, 100, 77, 12], device=DEV)
    max_blk = -(-(S + len(feed)) // bs)
    table = torch.arange(B * max_blk, dtype=torch.int32, device=DEV).view(B, max_blk)
    pools = P.init(None, m.paged_cache_specs(B * max_blk, bs), DEV)
    out = [m.prefill(params, {"tokens": toks}, S, true_len=true_len)[0],
           m.prefill_chunk_paged(params, toks, torch.zeros_like(true_len), true_len,
                                 pools, table)[0]]
    pos = true_len.clone()
    for f in feed:
        out.append(m.decode_step_paged(params, f, pos, pools, table)[0])
        pos = pos + 1
    out = [o.float() for o in out]
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{cfg.name}: non-finite logits (use_kernels={use_kernels})")
    return out


def vlm_path_logits(cfg, params, use_kernels: bool) -> list:
    """Logits (f32) of every call, in the dtype of ``params``: a prefill of
    4 right-padded prompts of 128, 100, 77 and 12 tokens behind seeded
    patches (the plain attention on both paths, as in the reference: flash
    has no prefix-LM mask), then 4 dense decode steps at positions that
    count the prefix, fed the same drawn tokens whatever the path."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models.lm import LM

    m = LM(cfg, with_overrides(BASELINE, use_kernels=use_kernels))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    B, S, prefix = 4, 128, cfg.num_vision_tokens
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    feed = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=gen, device=DEV)
    patches = torch.randn((B, prefix, cfg.d_model), generator=gen,
                          device=DEV) * PALI_PATCH_STD
    true_len = torch.tensor([128, 100, 77, 12], device=DEV)
    logits, caches = m.prefill(params, {"tokens": toks, "patches": patches},
                               prefix + S + len(feed), true_len=true_len)
    out = [logits]
    pos = true_len + prefix
    for f in feed:
        logits, caches = m.decode_step(params, f, pos, caches)
        out.append(logits)
        pos = pos + 1
    out = [o.float() for o in out]
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{cfg.name}: non-finite logits (use_kernels={use_kernels})")
    return out


def serve_submit(cfg, params, prompts, buckets, max_len: int, extras, seed: int) -> dict:
    """A model on the dense backend through ``InferenceEngine.submit`` (the
    completions API carries no patches or frames, as in the reference):
    requests of ``prompts`` tokens, 32 new each, request i with
    ``extras(i, gen)`` (paligemma's patches, whisper's frames); a prompt one
    past the largest bucket must bounce, since neither a vision prefix nor
    an encoder-decoder is ever chunked; no kernel may launch."""
    from repro_torch.serving import InferenceEngine, Request, SamplingParams, State

    eng = InferenceEngine(cfg, params=params, capacity=8, max_len=max_len,
                          buckets=buckets, kv_backend="dense", seed=SEED,
                          device=DEV)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    over = Request(rid=99, prompt=[1] * (buckets[-1] + 1))
    check(not eng.submit(over, now=0.0) and over.state is State.REJECTED,
          f"{cfg.name}: a prompt of {len(over.prompt)} tokens was not rejected")
    reqs = []
    for i, n in enumerate(prompts):
        reqs.append(Request(rid=i, prompt=[int(x) for x in rng.integers(0, cfg.vocab_size, n)],
                            sampling=SamplingParams(max_new_tokens=32),
                            extras=extras(i, gen)))
        check(eng.submit(reqs[-1], now=0.0), f"{cfg.name}: request {i} rejected")
    ops = kernel_ops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in ops.values():
        mod.launches = 0
    t0 = time.perf_counter()
    t = 0.0
    while eng.pending() and t < 400:
        eng.step(now=t)
        t += 1.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = eng.history
    stats = dict(
        backend="dense", requests=len(eng.finished), steps=len(hist),
        decode_steps=sum(1 for st in hist if st.tokens_out),
        tokens_out=sum(len(r.output) for r in reqs),
        prefill_tokens=sum(st.prefill_tokens for st in hist), wall_s=round(wall, 3),
        prefill_s=round(sum(st.prefill_s for st in hist), 3),
        decode_s=round(sum(st.decode_s for st in hist), 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        launches={name: m.launches for name, m in ops.items()},
        bucket_groups=bucket_groups(eng),
        chunk_steps=sum(1 for st in hist if st.chunk_rows))
    log(f"[serve] {cfg.name} {json.dumps(stats)}")
    for r in reqs:
        check(len(r.output) == 32 and r.state is State.DONE,
              f"{cfg.name}: request {r.rid} (prompt {len(r.prompt)}) got "
              f"{len(r.output)} tokens, state {r.state}")
        check(all(0 <= x < cfg.vocab_size for x in r.output),
              f"{cfg.name}: request {r.rid} produced an out-of-vocab token")
    check(stats["chunk_steps"] == 0, f"{cfg.name}: a request went chunked")
    check(all(n == 0 for n in stats["launches"].values()),
          f"{cfg.name}: a kernel ran ({stats['launches']})")
    return stats


def load_whole(arch: str, tag: str, num_layers: int | None = None):
    """A model drawn whole on the card (or its first ``num_layers``), its
    weight bytes checked."""
    from repro_torch.models import params as P

    t0 = time.perf_counter()
    cfg, params = load_model(arch, num_layers)
    torch.cuda.synchronize()
    nbytes = sum(t.nbytes for t in P.tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, weight bytes {nbytes:,} drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    check(nbytes == WEIGHT_BYTES[arch], f"{cfg.name}: {nbytes} weight bytes")
    return cfg, params


def phase_gemma_family(worst):
    """gemma-2b, gemma3-4b and paligemma-3b whole, one after another, each
    freed before the next: flash and paged decode at head_dim 256 first,
    then each model served, its decode step profiled against the
    weight-read bound and its kernel path held to the plain path
    (``compare_paths_deep``).  gemma-2b (MQA) on ``serve_traffic``, paged
    then dense: 18 paged launches a decode step, 18 flash a prefill group.
    gemma3-4b on ``gemma_traffic``, dense: 34 flash launches a group, window
    1024 in its 29 local layers.  paligemma-3b (``serve_submit``): no kernel."""
    release()
    t0 = time.perf_counter()
    out = check_kernels_d256(worst)
    launches = {name: 0 for name in kernel_ops()}
    models = {}

    def done(cfg, stats, prof, paths):
        runs = stats if isinstance(stats, list) else [stats]
        for st in runs:
            for name, n in st["launches"].items():
                launches[name] += n
        models[cfg.name] = {"serve": runs, "decode_step": step_vs_bound(cfg, prof),
                            "paths": paths}
        log(f"[family] {cfg.name} {json.dumps({k: models[cfg.name][k] for k in ('decode_step', 'paths')})}")

    cfg, params = load_whole("gemma-2b", "family")
    buckets = (32, 64, 128)
    runs = [serve(cfg, params, b, buckets, serve_traffic(cfg.vocab_size))
            for b in ("paged", "dense")]
    for st in runs:
        check_exact_serve(cfg, st, st["backend"])
    prof = profile_decode(cfg, params, "paged", buckets)
    check(prof["paged_launches_per_step"] == cfg.num_layers,
          f"{cfg.name}: {prof['paged_launches_per_step']} paged-decode launches "
          f"per decode step, not {cfg.num_layers}")
    done(cfg, runs, prof, compare_paths_deep(cfg, params, paged_path_logits, "family"))
    del params
    release()

    cfg, params = load_whole("gemma3-4b", "family")
    with FlashWindows() as fw:
        stats = serve(cfg, params, "dense", GEMMA_BUCKETS, gemma_traffic(cfg.vocab_size),
                      max_len=GEMMA_MAX_LEN)
    check_gemma_serve(cfg, stats)
    n_local = sum(cfg.layer_kind(i) == "attn_local" for i in range(cfg.num_layers))
    groups = len(stats["bucket_groups"])
    stats["flash_calls_by_window"] = fw.by_window
    check(fw.by_window == {cfg.local_window: n_local * groups,
                           0: (cfg.num_layers - n_local) * groups},
          f"{cfg.name}: flash calls by window {fw.by_window} for {groups} groups")
    prof = profile_decode(cfg, params, "dense", GEMMA_BUCKETS)
    done(cfg, stats, prof, compare_paths_deep(cfg, params, gemma_path_logits, "family"))
    m, tok, pos, caches = staged_prefill(cfg, params, GEMMA_STAGE_PROMPTS, GEMMA_BUCKETS[-1],
                                         GEMMA_MAX_LEN, SEED + 22)
    models[cfg.name]["staged"] = check_staged_bitwise(m, params, tok, pos, caches,
                                                      GEMMA_STAGE_COUNTS, "family")
    del params, caches, m
    release()

    cfg, params = load_whole("paligemma-3b", "family")

    def patches(i, gen):       # every other request behind seeded patches
        return {} if i % 2 else {"patches": torch.randn(
            (1, cfg.num_vision_tokens, cfg.d_model), generator=gen, device=DEV) * PALI_PATCH_STD}
    stats = serve_submit(cfg, params, PALI_PROMPTS, PALI_BUCKETS, PALI_MAX_LEN, patches,
                         seed=SEED + 6)
    prof = profile_decode(cfg, params, "dense", PALI_BUCKETS)
    done(cfg, stats, prof, compare_paths_deep(cfg, params, vlm_path_logits, "family"))
    del params
    release()

    out.update(launches=launches, models=models,
               phase_s=round(time.perf_counter() - t0, 1))
    log(f"[family] {json.dumps({'phase_s': out['phase_s'], 'launches': launches})}")
    log(f"[family] {gpu_line()}")
    return out


# -------------------------------------------------------------------- moe
MOE = "qwen3-moe-30b-a3b"
# the reference's MoE bar (tests/test_kernels.py: bf16 noise can flip router
# top-k), and the f32 bar of every model
MOE_LOGIT_REL_TOL = {torch.bfloat16: 6e-2, torch.float32: 1e-3}
MOE_SHORT_DEPTH = 4           # layers of the kernel-vs-plain bars
MOE_ERR_RATIO = 1.5           # deepest f32 depth: kernel vs plain, distance to f32
MOE_F32_MARGIN = 3e9          # device bytes left free beside the f32 copy


def check_exact_serve(cfg, stats, backend: str):
    """Exact launch counts of a decoder served on ``serve_traffic``: paged
    decode once a layer a decode step on the paged backend (and flash
    never), flash once a layer a bucketed prefill group on the dense one
    (and paged decode never)."""
    counts, steps, groups = stats["launches"], stats["decode_steps"], stats["bucket_groups"]
    check(stats["requests"] == 10, f"{cfg.name}: {stats['requests']} requests served")
    if backend == "paged":
        check(counts["paged_attention"] == cfg.num_layers * steps,
              f"{cfg.name} paged: {counts['paged_attention']} paged-decode launches "
              f"for {steps} decode steps x {cfg.num_layers} layers")
        check(counts["flash_attention"] == 0, f"{cfg.name} paged: flash ran")
        check(stats["prefix_hit_tokens"] > 0, f"{cfg.name} paged: no prefix-cache hits")
    else:
        check(groups and counts["flash_attention"] == cfg.num_layers * len(groups),
              f"{cfg.name} dense: {counts['flash_attention']} flash launches for "
              f"{len(groups)} bucketed prefill groups x {cfg.num_layers} layers")
        check(counts["paged_attention"] == 0, f"{cfg.name} dense: paged decode ran")
    check(counts["ssd_scan"] == 0, f"{cfg.name} {backend}: the SSD scan ran")


class Routes:
    """Records, through ``layers.moe_route``, the top-K expert ids every MoE
    layer chooses for every position, per call (:meth:`call` opens one) and
    layer.  ``forced``: such ids of another run, which every MoE layer then
    takes in place of its own top-K, weighted by its own router
    probabilities renormalised over them."""

    def __init__(self, forced=None):
        self.routes: list[list] = []
        self.replay = None if forced is None else iter([i for c in forced for i in c])

    def call(self):
        self.routes.append([])

    def __enter__(self):
        from repro_torch.models import layers as L
        self.mod, self.real = L, L.moe_route

        def route(p, x, c):
            w, idx, probs = self.real(p, x, c)
            if self.replay is not None:
                idx = next(self.replay)
                w = probs.gather(-1, idx)
                w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
            self.routes[-1].append(idx)
            return w, idx, probs

        L.moe_route = route
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.real


def moe_path_logits(cfg, params, use_kernels: bool, toks, true_len, feed,
                    forced=None):
    """Logits (f32) of every call, in the dtype of ``params``: a prefill of
    right-padded prompts (flash on the kernel path), a paged chunked prefill
    of the same prompts, then paged decode steps fed the tokens ``feed``
    whatever the path, so that calls compare across paths and dtypes.  Also
    the routes of every call (:class:`Routes`, ``forced`` imposed)."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models import params as P
    from repro_torch.models.lm import LM

    m = LM(cfg, with_overrides(BASELINE, use_kernels=use_kernels))
    B, S = toks.shape
    bs = 16
    max_blk = -(-(S + len(feed)) // bs)
    table = torch.arange(B * max_blk, dtype=torch.int32, device=DEV).view(B, max_blk)
    pools = P.init(None, m.paged_cache_specs(B * max_blk, bs), DEV)
    out = []
    with Routes(forced) as r:
        r.call()
        out.append(m.prefill(params, {"tokens": toks}, S, true_len=true_len)[0])
        r.call()
        out.append(m.prefill_chunk_paged(params, toks, torch.zeros_like(true_len),
                                         true_len, pools, table)[0])
        pos = true_len.clone()
        for f in feed:
            r.call()
            out.append(m.decode_step_paged(params, f, pos, pools, table)[0])
            pos = pos + 1
    out = [o.float() for o in out]
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{cfg.name}: non-finite logits (use_kernels={use_kernels})")
    return out, r.routes


def sets_differ(ra, rb) -> tuple[int, int]:
    """(position, layer) pairs whose top-K expert sets differ between two
    runs' routes, and all pairs."""
    pairs = [(a.sort(-1).values, b.sort(-1).values)
             for ca, cb in zip(ra, rb) for a, b in zip(ca, cb)]
    return (sum(int((a != b).any(-1).sum()) for a, b in pairs),
            sum(a.shape[0] * a.shape[1] for a, _ in pairs))


def moe_paged_path(cfg):
    """qwen3-moe's path for :func:`compare_paths_moe`: :func:`moe_path_logits`
    on 4 rows of 128 tokens (100, 77 and 12 valid on three) and 4 decode
    steps."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    true_len = torch.tensor([128, 100, 77, 12], device=DEV)
    feed = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=gen, device=DEV)

    def path(c, p, use_kernels, forced=None):
        return moe_path_logits(c, p, use_kernels, toks, true_len, feed, forced)
    return path


def layer_bytes(layer, itemsize=None) -> int:
    """Bytes of a layer's tensors as held, or at ``itemsize`` bytes each."""
    from repro_torch.models import params as P
    return sum(t.numel() * (itemsize or t.element_size()) for t in P.tree_leaves(layer))


def deepest_f32_depth(params, margin: float, trim: bool) -> int:
    """The deepest depth whose f32 copy (its layers, the embedding and the
    final norm) fits on the card beside the bf16 weights with ``margin``
    bytes to spare; with ``trim``, counting the bytes that releasing the
    bf16 layers past it frees."""
    f32 = [layer_bytes(x, 4) for x in params["layers"]]
    held = [layer_bytes(x) for x in params["layers"]]
    rest_f32 = sum(layer_bytes(params[k], 4) for k in ("embed", "final_norm"))
    free = torch.cuda.mem_get_info()[0]
    for depth in range(len(f32), 0, -1):
        freed = sum(held[depth:]) if trim else 0
        if sum(f32[:depth]) + rest_f32 + margin <= free + freed:
            return depth
    return 0


def compare_paths_moe(cfg, params, path, depth: int = MOE_SHORT_DEPTH,
                      margin: float = MOE_F32_MARGIN, tag: str = "moe",
                      trim: bool = False) -> dict:
    """An MoE model, the kernel path against the plain path on the same
    weights and inputs: ``path(cfg, params, use_kernels, forced)`` gives the
    logits of every call and the routes (e.g. :func:`moe_paged_path`); max
    |diff| / max |logits| per call.

    At ``depth`` layers of full width.  f32: kernel vs plain, each path
    routing for itself, held to the f32 bar.  bf16: rounding alone flips
    top-K sets at full width (near-uniform random routers; the plain bf16
    path against the f32 plain path shows it), and one flipped expert moves
    a row's logits by about as much as the bar.  So the bf16 bar is held
    with the plain path's experts imposed on the kernel path (what the
    kernels change, carried through every layer), and the readings with
    each path routing for itself are printed beside the plain bf16 path's
    own distance from f32 and the flip counts.  Then, at the deepest depth
    whose f32 copy fits on the card beside the bf16 weights, each path
    routing for itself, each bf16 path against the f32 plain path: the
    kernel path may be at most ``MOE_ERR_RATIO`` times as far from it as
    the plain path.  ``trim``: first release the bf16 layers past the
    deepest depth whose f32 copy fits once they are gone
    (``params["layers"]`` is cut there), for models whose whole bf16
    weights leave no room for an f32 copy of ``depth`` layers."""
    from repro_torch.models import params as P

    def run(n, p, use_kernels, forced=None):
        return path(dataclasses.replace(cfg, num_layers=n),
                    dict(p, layers=p["layers"][:n]), use_kernels, forced)

    def reads(a, b):
        return [rel(x, y) for x, y in zip(a, b)]

    def calls(r):
        return [f"{x:.2e}" for x in r]

    d = depth
    if trim:
        keep = deepest_f32_depth(params, margin, trim=True)
        check(keep >= d, f"{cfg.name}: an f32 copy of only {keep} layers fits on the card")
        if keep < len(params["layers"]):
            log(f"[{tag}] {cfg.name}: the bf16 layers past {keep} released for the paths")
            del params["layers"][keep:]
            release()
    (ko, kr), (po, pr) = run(d, params, True), run(d, params, False)
    fo, _ = run(d, params, True, forced=pr)
    p32 = P.tree_map(lambda t: t.float(), dict(params, layers=params["layers"][:d]))
    (k32, k32r), (f32, f32r) = run(d, p32, True), run(d, p32, False)
    del p32
    torch.cuda.empty_cache()
    free_r, plain_f32 = reads(ko, po), reads(po, f32)
    forced_r, r32 = reads(fo, po), reads(k32, f32)
    flips = {"kernel_vs_plain_bf16": sets_differ(kr, pr),
             "plain_bf16_vs_plain_f32": sets_differ(pr, f32r),
             "kernel_vs_plain_f32": sets_differ(k32r, f32r)}
    log(f"[{tag}] {cfg.name} {d} layers, bf16, each path routing for itself: kernel "
        f"vs plain rel per call {calls(free_r)}; plain bf16 vs plain f32 "
        f"{calls(plain_f32)} (a report)")
    log(f"[{tag}] {cfg.name} top-{cfg.experts_per_token} expert sets that differ, {d} "
        f"layers, (position, layer) pairs: " + json.dumps(flips))
    log(f"[{tag}] {cfg.name} {d} layers, bf16, the plain path's experts imposed on the "
        f"kernel path: kernel vs plain rel per call {calls(forced_r)} "
        f"(bar {MOE_LOGIT_REL_TOL[torch.bfloat16]})")
    log(f"[{tag}] {cfg.name} {d} layers, f32, each path routing for itself: kernel vs "
        f"plain rel per call {calls(r32)} (bar {MOE_LOGIT_REL_TOL[torch.float32]})")
    check(max(forced_r) <= MOE_LOGIT_REL_TOL[torch.bfloat16],
          f"{cfg.name} kernel-path logits off by rel {max(forced_r):.3e}, {d} "
          "layers bf16, experts imposed")
    check(max(r32) <= MOE_LOGIT_REL_TOL[torch.float32],
          f"{cfg.name} kernel-path logits off by rel {max(r32):.3e}, {d} layers f32")
    report = {f"bf16_{d}_layers_imposed": max(forced_r),
              f"bf16_{d}_layers_free": max(free_r),
              f"plain_bf16_vs_f32_{d}_layers": max(plain_f32),
              f"f32_{d}_layers": max(r32), "topk_sets_differ": flips}

    free = torch.cuda.mem_get_info()[0]
    deep = min(deepest_f32_depth(params, margin, trim=False), cfg.num_layers)
    check(deep >= d, f"{cfg.name}: an f32 copy of only {deep} layers fits beside the "
          f"bf16 weights ({free / 1e9:.2f} GB free)")
    (ko, _), (po, _) = run(deep, params, True), run(deep, params, False)
    p32 = P.tree_map(lambda t: t.float(), dict(params, layers=params["layers"][:deep]))
    fo, _ = run(deep, p32, False)
    del p32
    torch.cuda.empty_cache()
    err = {"kernel": reads(ko, fo), "plain": reads(po, fo)}
    log(f"[{tag}] {cfg.name} bf16 paths vs the f32 plain path, {deep} layers (the "
        f"deepest whose f32 copy fits beside the bf16 weights held; {free / 1e9:.2f} GB "
        f"were free), each path "
        f"routing for itself: rel per call kernel {calls(err['kernel'])}, plain "
        f"{calls(err['plain'])} (bar: kernel <= {MOE_ERR_RATIO} x plain)")
    check(max(err["kernel"]) <= MOE_ERR_RATIO * max(err["plain"]),
          f"{cfg.name} bf16 kernel path is rel {max(err['kernel']):.3e} from the f32 "
          f"plain path at {deep} layers, the plain bf16 path {max(err['plain']):.3e}")
    report.update(f32_ratio_depth=deep, vs_f32_kernel=max(err["kernel"]),
                  vs_f32_plain=max(err["plain"]),
                  ratio=max(err["kernel"]) / max(err["plain"]))
    return report


def phase_moe():
    """qwen3-moe-30b-a3b at full width and depth, served on the paged and
    the dense backend, its decode step profiled, and its kernel path held
    to the plain path.  Runs last, after every other model is freed."""
    release()
    log(f"[moe] device memory allocated before loading: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    cfg, params = load_model(MOE)
    log(f"[moe] weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    buckets = (32, 64, 128)
    stats = {}
    for b in ("paged", "dense"):
        stats[b] = serve(cfg, params, b, buckets, serve_traffic(cfg.vocab_size))
        check_exact_serve(cfg, stats[b], b)
    prof = profile_decode(cfg, params, "paged", buckets)
    check(prof["paged_launches_per_step"] == cfg.num_layers,
          f"{cfg.name}: {prof['paged_launches_per_step']} paged-decode launches "
          f"per decode step, not {cfg.num_layers}")
    stats["decode_profile"] = prof
    stats["paths"] = compare_paths_moe(cfg, params, moe_paged_path(cfg))
    del params
    release()
    stats["launches"] = {name: stats["paged"]["launches"][name]
                         + stats["dense"]["launches"][name] for name in kernel_ops()}
    stats["phase_s"] = round(time.perf_counter() - t0, 1)
    moe = prof.get("moe", {})
    log(f"[moe] {json.dumps({'phase_s': stats['phase_s'], 'launches': stats['launches'], 'decode_step_device_ms': prof['decode_step_device_ms'], 'decode_step_wall_ms': prof['decode_step_wall_ms'], 'busy_share': prof['device_busy_share'], **moe, **stats['paths']})}")
    log(f"[moe] {gpu_line()}")
    return stats


# ----------------------------------------------------------------- gemma3
GEMMA = "gemma3-27b"
GEMMA_BUCKETS = (128, 512, 2048)
GEMMA_MAX_LEN = 4096
GEMMA_PROMPTS = (12, 100, 400, 1000, 1100, 1500, 2000, 2600, 3000, 3600)
GEMMA_HEADS = (32, 16, 128)   # H, KV, head_dim
GEMMA_FLASH = (4, 2048)       # B, S = Sq = Skv of the flash checks
GEMMA_WINDOWS = (1024, 0, 1000)
GEMMA_SHORT_DEPTH = 6         # one period: five local layers, one global
GEMMA_ERR_RATIO = 1.5         # deepest f32 depth: kernel vs plain, distance to f32
GEMMA_F32_MARGIN = 6e9        # device bytes left free beside the f32 copy


def gemma_traffic(vocab: int):
    """10 requests of 12..3600 tokens: the 1000-token prompt wraps its ring
    (1024 slots) in decode, 1100..2000 go in one bucket-2048 group (the
    window biting inside flash), 2600..3600 in chunks of 2048 longer than
    the ring; 10 requests over 8 rows reuse two rows."""
    rng = np.random.default_rng(SEED + 5)
    return [[[int(x) for x in rng.integers(0, vocab, n)] for n in GEMMA_PROMPTS]]


def check_flash_gemma(worst) -> dict:
    """Flash alone at gemma3's heads (32 over 16, head_dim 128), B=4, S=2048,
    windows 1024, 0 and 1000 (no whole tile), bf16 and f32, against its
    plain version; then each window timed in bf16 beside SDPA with the same
    mask and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    B, S = GEMMA_FLASH
    H, KV, d = GEMMA_HEADS
    check_flash_cases([(B, S, H, KV, d, w) for w in GEMMA_WINDOWS], gen, worst, "gemma3")
    rows = {}
    for window in GEMMA_WINDOWS:
        rows[f"window_{window}"] = r = time_flash(B, S, H, KV, d, gen, window=window)
        log(f"[gemma3] flash_attention timing bf16: {json.dumps(r)}")
    torch.cuda.empty_cache()
    return rows


def check_gemma_serve(cfg, stats):
    counts, groups = stats["launches"], stats["bucket_groups"]
    check(stats["requests"] == len(GEMMA_PROMPTS),
          f"{cfg.name}: {stats['requests']} requests served")
    check(groups and counts["flash_attention"] == cfg.num_layers * len(groups),
          f"{cfg.name}: {counts['flash_attention']} flash launches for "
          f"{len(groups)} bucketed prefill groups x {cfg.num_layers} layers")
    check(2048 in groups, f"{cfg.name}: no prefill group at bucket 2048 ({groups})")
    check(stats["chunk_steps"] > 0, f"{cfg.name}: no prompt went chunked")
    check(counts["paged_attention"] == 0 and counts["ssd_scan"] == 0,
          f"{cfg.name}: paged decode or the SSD scan ran ({counts})")


def gemma_path_logits(cfg, params, use_kernels: bool) -> list:
    """Logits (f32) of every call along two rows' paths, in the dtype of
    ``params``: a bucketed prefill at 2048 (rows of 1500 and 1018 valid
    tokens; flash on the kernel path, the window biting on the 1500-token
    row), a 600-token chunk on row 0 (row 1 idle) through rings it
    overwrites, then 8 decode steps fed the same drawn tokens whatever the
    path, in which row 1 passes position 1024 and wraps its rings."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models.lm import LM

    m = LM(cfg, with_overrides(BASELINE, use_kernels=use_kernels))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    B, S = 2, GEMMA_BUCKETS[-1]
    V = cfg.vocab_size
    toks = torch.randint(0, V, (B, S), generator=gen, device=DEV)
    chunk = torch.randint(0, V, (B, S), generator=gen, device=DEV)
    feed = torch.randint(0, V, (8, B, 1), generator=gen, device=DEV)
    true_len = torch.tensor([1500, 1018], device=DEV)
    n_valid = torch.tensor([600, 0], device=DEV)
    logits, caches = m.prefill(params, {"tokens": toks}, GEMMA_MAX_LEN, true_len=true_len)
    out = [logits]
    logits, caches = m.prefill_chunk(params, chunk, true_len, n_valid, caches)
    out.append(logits[:1])                     # row 1 took no chunk
    pos = true_len + n_valid
    for f in feed:
        logits, caches = m.decode_step(params, f, pos, caches)
        out.append(logits)
        pos = pos + 1
    out = [o.float() for o in out]
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{cfg.name}: non-finite logits (use_kernels={use_kernels})")
    return out


def compare_paths_deep(cfg, params, path_logits, tag: str) -> dict:
    """The kernel path against the plain path on the same weights
    (``path_logits(cfg, params, use_kernels)``, e.g. :func:`gemma_path_logits`):
    max |diff| / max |logits| per call, at ``GEMMA_SHORT_DEPTH`` layers held
    to the bf16 and f32 bars; then at the deepest depth whose f32 copy fits
    beside the bf16 weights, each bf16 path against the f32 plain path, the
    kernel path at most ``GEMMA_ERR_RATIO`` times as far from it as the
    plain path.  ``tag`` heads the log lines."""
    from repro_torch.models import params as P

    def run(depth, p, use_kernels):
        return path_logits(dataclasses.replace(cfg, num_layers=depth),
                           dict(p, layers=p["layers"][:depth]), use_kernels)

    def reads(a, b):
        return [rel(x, y) for x, y in zip(a, b)]

    def calls(r):
        return [f"{x:.2e}" for x in r]

    d = GEMMA_SHORT_DEPTH
    report = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else P.tree_map(
            lambda t: t.float(), dict(params, layers=params["layers"][:d]))
        r = reads(run(d, p, True), run(d, p, False))
        del p
        torch.cuda.empty_cache()
        log(f"[{tag}] {d} layers, {str(dtype)[6:]}: kernel vs plain logits rel per "
            f"call {calls(r)} (bar {LOGIT_REL_TOL[dtype]})")
        check(max(r) <= LOGIT_REL_TOL[dtype],
              f"{cfg.name} kernel-path logits off by rel {max(r):.3e}, {d} layers {dtype}")
        report[f"{str(dtype)[6:]}_{d}_layers"] = max(r)

    layer_f32 = sum(t.numel() * 4 for t in P.tree_leaves(params["layers"][0]))
    rest_f32 = sum(t.numel() * 4 for k in ("embed", "final_norm")
                   for t in P.tree_leaves(params[k]))
    free = torch.cuda.mem_get_info()[0]
    depth = int(min(cfg.num_layers, (free - GEMMA_F32_MARGIN - rest_f32) // layer_f32))
    check(depth >= d, f"{cfg.name}: an f32 copy of only {depth} layers fits beside "
          f"the bf16 weights ({free / 1e9:.2f} GB free)")
    ko, po = run(depth, params, True), run(depth, params, False)
    p32 = P.tree_map(lambda t: t.float(), dict(params, layers=params["layers"][:depth]))
    fo = run(depth, p32, False)
    del p32
    torch.cuda.empty_cache()
    err = {"kernel": reads(ko, fo), "plain": reads(po, fo)}
    log(f"[{tag}] bf16 paths vs the f32 plain path, {depth} layers (the deepest "
        f"whose f32 copy fits beside the bf16 weights; {free / 1e9:.2f} GB were "
        f"free): rel per call kernel {calls(err['kernel'])}, plain "
        f"{calls(err['plain'])} (bar: kernel <= {GEMMA_ERR_RATIO} x plain)")
    check(max(err["kernel"]) <= GEMMA_ERR_RATIO * max(err["plain"]),
          f"{cfg.name} bf16 kernel path is rel {max(err['kernel']):.3e} from the f32 "
          f"plain path at {depth} layers, the plain bf16 path {max(err['plain']):.3e}")
    report.update(f32_ratio_depth=depth, vs_f32_kernel=max(err["kernel"]),
                  vs_f32_plain=max(err["plain"]),
                  ratio=max(err["kernel"]) / max(err["plain"]))
    return report


def phase_gemma3(worst):
    """gemma3-27b whole (62 layers, 54 GB of bf16 weights drawn on the card
    after every earlier model is freed), served on the dense backend (ring
    layers have no paged form) with flash windowed in its 52 local layers;
    flash first checked alone at its heads, the decode step profiled
    against the weight-read bound, the kernel path held to the plain path."""
    release()
    log(f"[gemma3] device memory allocated before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    flash_rows = check_flash_gemma(worst)
    cfg, params = load_whole(GEMMA, "gemma3")
    stats = serve(cfg, params, "dense", GEMMA_BUCKETS, gemma_traffic(cfg.vocab_size),
                  max_len=GEMMA_MAX_LEN)
    check_gemma_serve(cfg, stats)
    release()
    step = step_vs_bound(cfg, profile_decode(cfg, params, "dense", GEMMA_BUCKETS))
    paths = compare_paths_deep(cfg, params, gemma_path_logits, "gemma3")
    del params
    release()
    out = {"launches": stats["launches"], "serve": stats, "decode_step": step,
           "paths": paths, "flash": flash_rows,
           "phase_s": round(time.perf_counter() - t0, 1)}
    log(f"[gemma3] {json.dumps({k: out[k] for k in ('phase_s', 'launches', 'decode_step', 'paths')})}")
    log(f"[gemma3] {gpu_line()}")
    return out


# -------------------------------------------------------------------- zoo
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 16             # two whole Jamba blocks of the published 32
JAMBA_BUCKETS = (64, 256, 512)
JAMBA_SSD = (4, 512, 128, 64, 16, 1, 256)   # b, S, H, P, N, G, chunk
JAMBA_SHORT_DEPTH = 6         # SSM layers, attention at 4, MoE at 1, 3 and 5
ZOO_HEADS = (32, 8, 128)      # H, KV, head_dim of jamba's and mixtral's attention
MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 20           # the weight budget qwen3-moe used
MIXTRAL_MAX_LEN = 8192
MIXTRAL_BUCKETS = (128, 512, 2048, 8192)
MIXTRAL_LONG = (4100, 5000, 6000)   # past the window of 4096
MIXTRAL_FLASH = (1, 8192, 4096)     # B, S, window of flash alone
MIXTRAL_SHORT_DEPTH = 4
WHISPER = "whisper-small"
WHISPER_BUCKETS = (64, 128, 256, 512)
WHISPER_MAX_LEN = 1024
WHISPER_PROMPTS = (12, 20, 40, 64, 90, 100, 128, 150, 180, 200)
WHISPER_FRAME_STD = 0.02
# device bytes left free beside the f32 copy of the paths' ratio: the plain
# f32 path's activations at their prefill (jamba: 4 rows of 512; mixtral:
# 2 rows of 5120, where an expert's slots of a row number 1600)
ZOO_F32_MARGIN = {JAMBA: 6e9, MIXTRAL: 12e9}


def check_kernels_zoo(worst) -> dict:
    """The SSD scan at jamba's heads (b=4, S=512, H=128, P=64, N=16, G=1,
    chunk 256, and one row with a right-padded tail of 137) and flash at
    jamba's prefill group (B=4, S=512, 32 heads over 8, d=128) and at
    mixtral's window (B=1, S=8192, window 4096: 64 key tiles), each in bf16
    and f32 against its plain version; then each timed in bf16 beside its
    bound, the SSD scan by events and device time, flash beside SDPA with
    the same mask."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 23)
    b, S, H, P, N, G, Q = JAMBA_SSD
    check_ssd_cases(H, P, N, G, [(b, S, Q, 0, False), (1, S, Q, 137, False)], gen, worst,
                    "zoo")
    ssd = time_ssd(b, S, H, P, N, G, Q, gen)
    log(f"[zoo] ssd_scan timing bf16: {json.dumps(ssd)}")
    B_m, S_m, w_m = MIXTRAL_FLASH
    check_flash_cases([(4, 512, *ZOO_HEADS, 0), (B_m, S_m, *ZOO_HEADS, w_m)], gen, worst,
                      "zoo")
    flash = {"jamba_B4_S512": time_flash(4, 512, *ZOO_HEADS, gen),
             f"mixtral_B{B_m}_S{S_m}_window_{w_m}": time_flash(B_m, S_m, *ZOO_HEADS, gen,
                                                               window=w_m)}
    for key, r in flash.items():
        log(f"[zoo] flash_attention timing bf16 {key}: {json.dumps(r)}")
    release()
    return {"ssd": ssd, "flash": flash}


def dense_path(cfg, S: int, true_len, chunk: int, steps: int, max_len: int, seed: int):
    """A path for :func:`compare_paths_moe` on the dense caches: a bucketed
    prefill of right-padded rows of ``S`` tokens, ``true_len`` valid (flash,
    and the SSD scan on SSM layers, on the kernel path), a chunk of
    ``chunk`` tokens appended to row 0 with the other rows idle (the SSM,
    attention and ring chunk modes), then ``steps`` decode steps fed the
    same drawn tokens whatever the path.  Returns ``path(cfg, params,
    use_kernels, forced)`` -> (f32 logits of every call, the routes)."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models.lm import LM

    gen = torch.Generator(device=DEV).manual_seed(seed)
    V, B = cfg.vocab_size, len(true_len)
    toks = torch.randint(0, V, (B, S), generator=gen, device=DEV)
    more = torch.randint(0, V, (B, chunk), generator=gen, device=DEV)
    feed = torch.randint(0, V, (steps, B, 1), generator=gen, device=DEV)
    tl = torch.tensor(true_len, device=DEV)
    n_valid = torch.zeros_like(tl)
    n_valid[0] = chunk

    def path(c, params, use_kernels, forced=None):
        m = LM(c, with_overrides(BASELINE, use_kernels=use_kernels))
        out = []
        with Routes(forced) as r:
            r.call()
            logits, caches = m.prefill(params, {"tokens": toks}, max_len, true_len=tl)
            out.append(logits)
            r.call()
            logits, caches = m.prefill_chunk(params, more, tl, n_valid, caches)
            out.append(logits[:1])                     # the other rows took no chunk
            pos = tl + n_valid
            for f in feed:
                r.call()
                logits, caches = m.decode_step(params, f, pos, caches)
                out.append(logits)
                pos = pos + 1
        out = [o.float() for o in out]
        check(all(bool(torch.isfinite(o).all()) for o in out),
              f"{c.name}: non-finite logits (use_kernels={use_kernels})")
        return out, r.routes
    return path


def check_jamba_serve(cfg, stats):
    """14 SSD scans and 2 flash a bucketed prefill group (16 layers: SSM
    but at 4 and 12), paged decode never; the 700-token prompt chunked
    beside decoding rows."""
    counts, groups = stats["launches"], stats["bucket_groups"]
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
    check(stats["requests"] == 10, f"{cfg.name}: {stats['requests']} requests served")
    check(groups and counts["ssd_scan"] == n_ssm * len(groups)
          and counts["flash_attention"] == (cfg.num_layers - n_ssm) * len(groups),
          f"{cfg.name}: {counts} launches for {len(groups)} bucketed prefill groups "
          f"of {n_ssm} SSM and {cfg.num_layers - n_ssm} attention layers")
    check(counts["paged_attention"] == 0, f"{cfg.name}: paged decode ran")
    check(512 in groups, f"{cfg.name}: no prefill group at bucket 512 ({groups})")
    check(stats["chunk_steps_with_decode"] > 0,
          f"{cfg.name}: the chunked prompt never advanced beside decoding rows")


def mixtral_traffic(vocab: int):
    """``gemma_traffic``'s 10 requests (12..3600 tokens) and three past the
    window (4100, 5000, 6000 tokens): with buckets up to 8192 and a prefill
    budget of 8192 tokens a step, each prompt above 2048 tokens is prefilled
    alone in a bucket-8192 group; the three longest have flash's window bite
    and decode through rings that have wrapped."""
    rng = np.random.default_rng(SEED + 25)
    long = [[int(x) for x in rng.integers(0, vocab, n)] for n in MIXTRAL_LONG]
    return [gemma_traffic(vocab)[0] + long]


def check_mixtral_serve(cfg, stats):
    """20 flash launches a bucketed prefill group, every one at window 4096;
    one row a bucket-8192 group; no chunk, no paged decode."""
    counts, groups = stats["launches"], stats["bucket_groups"]
    n = len(GEMMA_PROMPTS) + len(MIXTRAL_LONG)
    check(stats["requests"] == n, f"{cfg.name}: {stats['requests']} requests served")
    check(groups and counts["flash_attention"] == cfg.num_layers * len(groups),
          f"{cfg.name}: {counts['flash_attention']} flash launches for {len(groups)} "
          f"bucketed prefill groups x {cfg.num_layers} layers")
    check(stats["flash_calls_by_window"] == {cfg.sliding_window: cfg.num_layers * len(groups)},
          f"{cfg.name}: flash calls by window {stats['flash_calls_by_window']}")
    long = [r for b, r in stats["group_rows"] if b == MIXTRAL_BUCKETS[-1]]
    check(len(long) == 6 and set(long) == {1},
          f"{cfg.name}: bucket-8192 groups of {long} rows")
    check(counts["paged_attention"] == 0 and counts["ssd_scan"] == 0,
          f"{cfg.name}: paged decode or the SSD scan ran ({counts})")


def encdec_step_bound(cfg, rows: int, ctx: int) -> tuple[float, int]:
    """The least time an encoder-decoder's decode step can take at 3.35 TB/s,
    (ms, bytes): the decoder's weights, the final norm and the tied table
    (the unembedding reads it whole) read once, and for each of ``rows``
    rows every layer's bf16 cross-KV (``encoder_seq`` positions) and
    self-KV (``ctx`` positions).  The encoder's weights are not read."""
    from repro_torch.models import params as P
    from repro_torch.models.lm import make_model

    specs = make_model(cfg).param_specs()
    nbytes = sum(P.count_bytes(specs[k]) for k in ("decoder", "final_norm", "embed"))
    per_pos = cfg.num_layers * rows * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    nbytes += per_pos * (cfg.encoder_seq + ctx)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def encdec_path_logits(cfg, params, use_kernels: bool) -> list:
    """Logits (f32) of every call, in the dtype of ``params``: a prefill of 4
    right-padded prompts of 128, 100, 77 and 12 tokens behind seeded frames,
    then 4 decode steps reading the cross-KV, fed the same drawn tokens
    whatever the path."""
    from repro_torch.configs.perf import BASELINE, with_overrides
    from repro_torch.models.lm import make_model

    m = make_model(cfg, with_overrides(BASELINE, use_kernels=use_kernels))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 27)
    B, S = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV)
    feed = torch.randint(0, cfg.vocab_size, (4, B, 1), generator=gen, device=DEV)
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=DEV) * WHISPER_FRAME_STD
    true_len = torch.tensor([128, 100, 77, 12], device=DEV)
    logits, caches = m.prefill(params, {"tokens": toks, "frames": frames}, S + len(feed),
                               true_len=true_len)
    out = [logits]
    pos = true_len.clone()
    for f in feed:
        logits, caches = m.decode_step(params, f, pos, caches)
        out.append(logits)
        pos = pos + 1
    out = [o.float() for o in out]
    check(all(bool(torch.isfinite(o).all()) for o in out),
          f"{cfg.name}: non-finite logits (use_kernels={use_kernels})")
    return out


def compare_paths_encdec(cfg, params) -> dict:
    """whisper whole: the bf16 kernel path (no kernel runs on it: the
    reference takes the plain attention everywhere here) and the bf16 plain
    path, each against the f32 plain path; the kernel path at most
    ``GEMMA_ERR_RATIO`` times as far from it as the plain path."""
    from repro_torch.models import params as P

    ko, po = encdec_path_logits(cfg, params, True), encdec_path_logits(cfg, params, False)
    fo = encdec_path_logits(cfg, P.tree_map(lambda t: t.float(), params), False)
    err = {"kernel": [rel(x, y) for x, y in zip(ko, fo)],
           "plain": [rel(x, y) for x, y in zip(po, fo)]}
    log(f"[zoo] {cfg.name} bf16 paths vs the f32 plain path, whole: rel per call "
        f"kernel {[f'{x:.2e}' for x in err['kernel']]}, plain "
        f"{[f'{x:.2e}' for x in err['plain']]} (bar: kernel <= {GEMMA_ERR_RATIO} x plain)")
    check(max(err["kernel"]) <= GEMMA_ERR_RATIO * max(err["plain"]),
          f"{cfg.name} bf16 kernel path is rel {max(err['kernel']):.3e} from the f32 "
          f"plain path, the plain bf16 path {max(err['plain']):.3e}")
    return {"vs_f32_kernel": max(err["kernel"]), "vs_f32_plain": max(err["plain"]),
            "ratio": max(err["kernel"]) / max(err["plain"])}


def phase_zoo(worst):
    """The rest of the model zoo, one model after another, each freed before
    the next, after the kernels are checked and timed at their shapes
    (:func:`check_kernels_zoo`).  jamba-v0.1-52b at 16 of its 32 layers
    (52.0 GB) on ``mamba_traffic``, dense: 14 SSD scans and 2 flash a
    prefill group; mixtral-8x7b at 20 of 32 (58.6 GB) on
    ``mixtral_traffic`` at max_len 8192, dense: 20 flash a group, all at
    window 4096; whisper-small whole through ``InferenceEngine.submit`` with
    seeded frames: no kernel.  Each decode step profiled against its bound
    (the MoE models split by part), each kernel path held to its plain path
    (``compare_paths_moe``, ``compare_paths_encdec``)."""
    from repro_torch.serving import SchedulerConfig

    release()
    log(f"[zoo] device memory allocated before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    out = check_kernels_zoo(worst)
    launches = {name: 0 for name in kernel_ops()}
    models = {}

    def done(cfg, stats, step, paths):
        for name, n in stats["launches"].items():
            launches[name] += n
        models[cfg.name] = {"serve": stats, "decode_step": step, "paths": paths}
        log(f"[zoo] {cfg.name} {json.dumps({k: models[cfg.name][k] for k in ('decode_step', 'paths')})}")

    def moe_step(cfg, prof):
        return dict(step_vs_bound(cfg, prof), moe=prof.get("moe", "not measured"))

    cfg, params = load_whole(JAMBA, "zoo", JAMBA_LAYERS)
    stats = serve(cfg, params, "dense", JAMBA_BUCKETS, mamba_traffic(cfg.vocab_size))
    check_jamba_serve(cfg, stats)
    step = moe_step(cfg, profile_decode(cfg, params, "dense", JAMBA_BUCKETS))
    path = dense_path(cfg, 512, (512, 400, 300, 12), chunk=300, steps=4, max_len=1024,
                      seed=SEED + 29)
    done(cfg, stats, step, compare_paths_moe(cfg, params, path, JAMBA_SHORT_DEPTH,
                                             ZOO_F32_MARGIN[JAMBA], "zoo", trim=True))
    del params
    release()

    cfg, params = load_whole(MIXTRAL, "zoo", MIXTRAL_LAYERS)
    with FlashWindows() as fw:
        stats = serve(cfg, params, "dense", MIXTRAL_BUCKETS, mixtral_traffic(cfg.vocab_size),
                      max_len=MIXTRAL_MAX_LEN,
                      sched=SchedulerConfig(prefill_token_budget=MIXTRAL_BUCKETS[-1]))
    stats["flash_calls_by_window"] = fw.by_window
    check_mixtral_serve(cfg, stats)
    release()
    step = moe_step(cfg, profile_decode(cfg, params, "dense", MIXTRAL_BUCKETS))
    path = dense_path(cfg, 5120, (5120, 4200), chunk=600, steps=4,
                      max_len=MIXTRAL_MAX_LEN, seed=SEED + 31)
    done(cfg, stats, step, compare_paths_moe(cfg, params, path, MIXTRAL_SHORT_DEPTH,
                                             ZOO_F32_MARGIN[MIXTRAL], "zoo", trim=True))
    del params
    release()

    cfg, params = load_whole(WHISPER, "zoo")

    def frames(i, gen):
        return {"frames": torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                                      device=DEV) * WHISPER_FRAME_STD}
    stats = serve_submit(cfg, params, WHISPER_PROMPTS, WHISPER_BUCKETS, WHISPER_MAX_LEN,
                         frames, seed=SEED + 21)
    prof = profile_decode(cfg, params, "dense", WHISPER_BUCKETS)
    step = step_vs_bound(cfg, prof, encdec_step_bound(cfg, rows=8, ctx=300))
    done(cfg, stats, step, compare_paths_encdec(cfg, params))
    del params
    release()

    out.update(launches=launches, models=models,
               phase_s=round(time.perf_counter() - t0, 1))
    log(f"[zoo] {json.dumps({'phase_s': out['phase_s'], 'launches': launches})}")
    log(f"[zoo] {gpu_line()}")
    return out


# ------------------------------------------------------------------ train
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5)
TRAIN_CHECK = (2, 2, 256)     # layers, B, S of the card step held to the CPU step
TRAIN_STEP_REL = 1e-4
TRAIN_QWEN = (8, 1024, 30)    # B, S, steps of qwen2-0.5b whole
TRAIN_CKPT_EVERY = 10
TRAIN_FAIL_AT = 15
TRAIN_RESUME_TOL = 1e-5
TRAIN_ZOO = ((MAMBA, 8, 1024), (WHISPER, 8, 448))   # arch, B, S; 10 steps each
TRAIN_ZOO_STEPS = 10
TRAIN_ZOO_RESUME = {MAMBA: 5}   # arch: the step a second trainer resumes at
TRAIN_RESUME_LOSS_REL = 1e-2    # of the loss: bf16 rounding under a nondeterministic cumsum


def leaf_rel(a_tree, b_tree) -> float:
    """The largest max |a - b| / max |b| over the leaves (b on the CPU)."""
    from repro_torch.models import params as P

    return max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in P.tree_zip(a_tree, b_tree) if b.numel())


def check_train_step():
    """qwen2-0.5b at full width cut to 2 layers, f32 weights drawn on the
    card, B=2, S=256: the gradients of the loss on the card and on the CPU
    (each leaf within 1e-4 of its largest magnitude); one ``train_step`` on
    each (loss and gradient norm within 1e-4); and AdamW on the card applied
    to the CPU's gradients against the CPU step's parameters (each leaf
    within 1e-4).  The updated leaves of the two whole steps are reported:
    AdamW's first step divides each gradient by its own magnitude, so an
    entry whose gradient is within rounding of zero may move either way,
    by up to twice the learning rate, on any two devices or thread
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as P
    from repro_torch.models.lm import make_model
    from repro_torch.training.data import BigramStream, DataConfig
    from repro_torch.training.optimizer import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.training.steps import loss_and_grads, make_train_step

    layers, B, S = TRAIN_CHECK
    cfg = dataclasses.replace(get_config(QWEN), num_layers=layers)
    specs = make_model(cfg).param_specs()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    card = P.tree_map(lambda t: t.float(), P.init(gen, specs, DEV))
    host = P.tree_map(lambda t: t.cpu(), card)
    batch = BigramStream(cfg, DataConfig(batch=B, seq_len=S), DEV).batch(0)
    hbatch = {k: v.cpu() for k, v in batch.items()}
    opt = AdamWConfig(**TRAIN_OPT)
    model, step = make_train_step(cfg, opt_cfg=opt)

    def clone(tree):
        return P.tree_map(lambda t: t.clone(), tree)

    t0 = time.perf_counter()
    _, _, grads_c = loss_and_grads(model, card, batch)
    _, _, grads_h = loss_and_grads(model, host, hbatch)
    pc, _, mc = step(clone(card), init_opt_state(specs, DEV), batch)
    ph, _, mh = step(clone(host), init_opt_state(specs, "cpu"), hbatch)
    pa, _, _ = apply_updates(clone(card), P.tree_map(lambda g: g.to(DEV), grads_h),
                             init_opt_state(specs, DEV), opt)
    flipped = sum(int(((a.cpu() - p0) * (b - p0) < 0).sum())
                  for a, b, p0 in P.tree_zip(pc, ph, host))
    out = {"loss_card": float(mc["loss"]), "loss_cpu": float(mh["loss"]),
           "loss_rel": abs(float(mc["loss"]) - float(mh["loss"])) / abs(float(mh["loss"])),
           "grad_norm_rel": abs(float(mc["grad_norm"]) - float(mh["grad_norm"]))
           / float(mh["grad_norm"]),
           "grad_leaf_rel": leaf_rel(grads_c, grads_h),
           "adamw_on_cpu_grads_leaf_rel": leaf_rel(pa, ph),
           "step_leaf_rel_reported": leaf_rel(pc, ph),
           "entries_moved_apart_reported": flipped,
           "s": round(time.perf_counter() - t0, 1)}
    log(f"[train] {cfg.name} at {layers} layers, f32, B={B}, S={S}, card vs CPU: "
        f"{json.dumps(out)}")
    check(out["loss_rel"] <= TRAIN_STEP_REL and out["grad_norm_rel"] <= TRAIN_STEP_REL,
          f"train step on the card: loss or gradient norm off the CPU's ({out})")
    check(out["grad_leaf_rel"] <= TRAIN_STEP_REL,
          f"train step on the card: gradients off the CPU's ({out})")
    check(out["adamw_on_cpu_grads_leaf_rel"] <= TRAIN_STEP_REL,
          f"AdamW on the card: updated leaves off the CPU's ({out})")
    return out


def train_work(cfg, B: int, S: int) -> dict:
    """The operations and bytes of one training step of a decoder-only LM
    with full remat (``perf.remat = "full"``) and the chunked cross-entropy:
    the products of every layer (projections, MLP; causal attention pairs)
    and of the unembedding, forward once, again in the backward pass
    (recomputed) and twice for the backward itself; the bytes of the weights
    read in those three passes, the gradients written and AdamW's pass over
    parameters, gradients and both f32 moments."""
    from repro_torch.models import params as P
    from repro_torch.models.lm import make_model

    D, H, KV, hd, F_, V, L_ = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.num_layers)
    T = B * S
    layer = 2 * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F_) * T   # forward
    attn = 2 * 2 * B * H * hd * S * (S + 1) // 2                        # causal pairs
    unembed = 2 * B * (S - 1) * D * V
    model = 3 * (L_ * (layer + attn) + unembed)
    executed = model + L_ * (layer + attn) + unembed
    wbytes = P.count_bytes(make_model(cfg).param_specs())
    n = wbytes // 2                         # bf16 parameters
    nbytes = 3 * wbytes + wbytes + (2 * wbytes + wbytes + 4 * 4 * n)
    return {"model_flops": model, "executed_flops": executed, "bytes": nbytes,
            "matmul_params": L_ * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F_) + D * V}


def profile_train_step(step_fn, params, opt_state, batch, wall_ms: float) -> dict:
    """One more step under torch.profiler: the device rows summed (the
    device's busy time), its share of ``wall_ms`` (the unprofiled step's
    wall time: the profiler slows the host), and the ops that hold the
    device longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    dev_ms = sum(dev_us(e) for e in events if on_device(e)) / 1e3
    top = [(e.key[:48], round(dev_us(e) / 1e3, 2), e.count)
           for e in events if dev_us(e) > 0 and not on_device(e)][:8]
    return {"profiled_step_wall_ms": round(wall * 1e3, 1),
            "device_ms": round(dev_ms, 1) if dev_ms else "not measured",
            "busy_share": round(dev_ms / wall_ms, 3) if dev_ms else "not measured",
            "top_ops_device_ms_and_calls": top}


def timed_trainer(trainer, times: list):
    """Time each ``train_step`` of ``trainer`` (synchronised) into ``times``."""
    fn = trainer._step_fn

    def step(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    trainer._step_fn = step
    return trainer


def train_qwen_whole(workdir: Path) -> dict:
    """qwen2-0.5b whole (24 layers, bf16) through ``Trainer`` on
    ``BigramStream``, B=8, S=1024, 30 steps, async checkpoints every 10,
    under deterministic algorithms: losses finite and falling; then a run
    that fails at step 15 and a third ``Trainer`` that resumes at 10 and
    must repeat the uninterrupted losses of steps 10-29 (1e-5), its
    restored state first read back onto the CPU bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import params as P
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer, TrainConfig

    cfg = get_config(QWEN)
    B, S, steps = TRAIN_QWEN
    dcfg = DataConfig(batch=B, seq_len=S)

    def trainer(name, **kw):
        return Trainer(cfg, TrainConfig(steps=steps, ckpt_every=TRAIN_CKPT_EVERY,
                                        ckpt_dir=str(workdir / name), seed=SEED,
                                        log_every=TRAIN_CKPT_EVERY),
                       dcfg, opt=AdamWConfig(**TRAIN_OPT), device=DEV, **kw)

    torch.use_deterministic_algorithms(True)
    try:
        release()
        torch.cuda.reset_peak_memory_stats()
        times: list = []
        t0 = time.perf_counter()
        ta = timed_trainer(trainer("a"), times)
        losses = ta.run()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"{cfg.name}: non-finite training losses {losses}")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        uniform = ta.data.uniform_nll()
        step_ms = float(np.median(times[1:])) * 1e3
        log(f"[train] {cfg.name} whole, B={B}, S={S}: losses {[round(x, 4) for x in losses]}; "
            f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}, uniform ln V "
            f"{uniform:.4f}")
        check(last < first, f"{cfg.name}: losses do not fall ({first:.4f} -> {last:.4f})")
        prof = profile_train_step(ta._step_fn, ta.params, ta.opt_state,
                                  ta.data.batch(steps), step_ms)
        del ta
        shutil.rmtree(workdir / "a")

        with_fail = trainer("b", fail_at_step=TRAIN_FAIL_AT)
        try:
            with_fail.run()
        except RuntimeError as e:
            check("injected failure" in str(e), f"{cfg.name}: the failing run raised {e!r}")
        else:
            check(False, f"{cfg.name}: the run with fail_at_step={TRAIN_FAIL_AT} did not fail")
        del with_fail
        release()
        tc = trainer("b")
        check(tc.start_step == TRAIN_CKPT_EVERY,
              f"{cfg.name}: resumed at step {tc.start_step}, not {TRAIN_CKPT_EVERY}")
        state = {"params": tc.params, "opt": tc.opt_state}
        host, _ = CKPT.restore_state(str(workdir / "b"), TRAIN_CKPT_EVERY,
                                     P.tree_map(lambda t: t.cpu(), state), cfg, device="cpu")
        check(all(h.device.type == "cpu" and h.dtype == c.dtype
                  and torch.equal(h.view(torch.int16) if h.dtype == torch.bfloat16 else h,
                                  (c.view(torch.int16) if c.dtype == torch.bfloat16 else c).cpu())
                  for h, c in P.tree_zip(host, state)),
              f"{cfg.name}: a checkpoint written on the card reads back otherwise on the CPU")
        resumed = tc.run()
        diff = float(np.abs(np.array(resumed) - np.array(losses[TRAIN_CKPT_EVERY:])).max())
        log(f"[train] {cfg.name} resumed at step {tc.start_step} after a failure at "
            f"{TRAIN_FAIL_AT}: losses of steps {TRAIN_CKPT_EVERY}-{steps - 1} at most "
            f"{diff:.3e} from the uninterrupted run's (bar {TRAIN_RESUME_TOL})")
        check(diff <= TRAIN_RESUME_TOL, f"{cfg.name}: resumed losses differ by {diff:.3e}")
        del tc, state, host
        shutil.rmtree(workdir / "b")
    finally:
        torch.use_deterministic_algorithms(False)

    work = train_work(cfg, B, S)
    bound_ms, bound_by = bound(work["bytes"], work["executed_flops"], torch.bfloat16)
    out = {"steps": steps, "step_wall_ms_median": round(step_ms, 1),
           "step_wall_ms_first": round(times[0] * 1e3, 1),
           "loop_s_per_step": round(run_s / steps, 3),
           "tokens_per_s": round(B * S / step_ms * 1e3, 1),
           "peak_memory_gib": round(peak / 2**30, 2), **prof,
           "matmul_params": work["matmul_params"], "model_flops": work["model_flops"],
           "executed_flops": work["executed_flops"],
           "step_bound_ms": round(bound_ms, 2), "bound_by": bound_by,
           "bound_share": round(bound_ms / step_ms, 4),
           "model_flop_share": round(work["model_flops"] / PEAK_FLOPS[torch.bfloat16]
                                     / (step_ms / 1e3), 4),
           "loss_first5": first, "loss_last5": last, "uniform_nll": uniform,
           "resume_max_diff": diff}
    log(f"[train] {cfg.name} whole: {json.dumps(out)}")
    return out


def train_zoo_model(arch: str, B: int, S: int, workdir: Path) -> dict:
    """``TRAIN_ZOO_STEPS`` Trainer steps of a model whole (bf16, seeded
    frames for whisper): losses finite and falling, step wall, peak, and
    one more step profiled by op.  An arch of ``TRAIN_ZOO_RESUME`` is also
    checkpointed at that step, and a second ``Trainer`` resumes there: its
    losses must stay within ``TRAIN_RESUME_LOSS_REL`` of the uninterrupted
    run's (an SSM's scan takes a ``cumsum`` with no deterministic CUDA
    form, so the two differ by rounding; a resume that lost state, fresh
    moments or a restarted warm-up, differs by far more)."""
    from repro_torch.configs import get_config
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer, TrainConfig

    cfg = get_config(arch)
    resume_at = TRAIN_ZOO_RESUME.get(arch)
    release()
    torch.cuda.reset_peak_memory_stats()
    times: list = []

    def trainer(d):
        return Trainer(cfg, TrainConfig(steps=TRAIN_ZOO_STEPS,
                                        ckpt_every=resume_at or TRAIN_ZOO_STEPS,
                                        ckpt_dir=str(d), seed=SEED,
                                        log_every=TRAIN_ZOO_STEPS),
                       DataConfig(batch=B, seq_len=S), opt=AdamWConfig(**TRAIN_OPT),
                       device=DEV)

    t = timed_trainer(trainer(workdir / arch), times)
    losses = t.run()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{cfg.name}: non-finite training losses {losses}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    step_ms = float(np.median(times[1:])) * 1e3
    out = {"B": B, "S": S, "losses": [round(x, 4) for x in losses],
           "step_wall_ms_median": round(step_ms, 1),
           "tokens_per_s": round(B * S / step_ms * 1e3, 1),
           "peak_memory_gib": round(peak / 2**30, 2), "uniform_nll": t.data.uniform_nll(),
           **profile_train_step(t._step_fn, t.params, t.opt_state,
                                t.data.batch(TRAIN_ZOO_STEPS), step_ms)}
    log(f"[train] {cfg.name} whole: {json.dumps(out)}")
    check(last < first, f"{cfg.name}: losses do not fall ({first:.4f} -> {last:.4f})")
    del t
    if resume_at:
        release()
        step_dir = f"step_{resume_at:08d}"
        shutil.copytree(workdir / arch / step_dir, workdir / f"{arch}-resume" / step_dir)
        shutil.rmtree(workdir / arch)
        t = trainer(workdir / f"{arch}-resume")
        check(t.start_step == resume_at, f"{cfg.name}: resumed at step {t.start_step}")
        resumed = t.run()
        diff = np.abs(np.array(resumed) - np.array(losses[resume_at:]))
        worst = float((diff / np.abs(losses[resume_at:])).max())
        out["resume"] = {"at": resume_at, "losses": [round(x, 6) for x in resumed],
                         "max_abs_diff": float(diff.max()), "max_rel_diff": worst}
        log(f"[train] {cfg.name} resumed at step {resume_at}: losses of steps {resume_at}-"
            f"{TRAIN_ZOO_STEPS - 1} at most {float(diff.max()):.3e} ({worst:.3e} of the loss) "
            f"from the uninterrupted run's (bar {TRAIN_RESUME_LOSS_REL} of the loss)")
        check(worst <= TRAIN_RESUME_LOSS_REL,
              f"{cfg.name}: resumed losses differ by {worst:.3e} of the loss")
        del t
        arch = f"{arch}-resume"
    shutil.rmtree(workdir / arch)
    return out


def check_wrappers_refuse_autograd() -> None:
    """flash attention and the SSD scan (and paged decode) on CUDA inputs
    that require grad, under grad mode: each must raise before it launches."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    H, KV, d = QWEN_HEADS
    q = torch.randn((1, 64, H, d), device=DEV, dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn((1, 64, KV, d), device=DEV, dtype=torch.bfloat16) for _ in range(2))
    x = torch.randn((1, 64, 4, 64), device=DEV, dtype=torch.bfloat16, requires_grad=True)
    Bm, Cm = (torch.randn((1, 64, 1, 128), device=DEV, dtype=torch.bfloat16) for _ in range(2))
    dt = torch.rand((1, 64, 4), device=DEV)
    pools = [torch.randn((4, 16, KV, d), device=DEV, dtype=torch.bfloat16) for _ in range(2)]
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=DEV)
    ctx = torch.tensor([20], dtype=torch.int32, device=DEV)
    calls = {"flash_attention": lambda: attention(q, k, v),
             "ssd_scan": lambda: ssd_scan(x, Bm, Cm, dt, -dt, chunk=64),
             "paged_attention": lambda: paged_decode_attention(q[:, 0], *pools, table, ctx)}
    ops = kernel_ops()
    for name, call in calls.items():
        n0 = ops[name].launches
        try:
            call()
        except RuntimeError as e:
            check("has no backward" in str(e), f"{name} under autograd raised {e!r}")
        else:
            check(False, f"{name} ran under autograd on the card")
        check(ops[name].launches == n0, f"{name} launched under autograd")
    log("[train] flash attention, the SSD scan and paged decode refuse autograd on the card")


def run_train_launcher(workdir: Path) -> dict:
    """``python -m repro_torch.launch.train --arch qwen2-0.5b --steps 3`` as a
    subprocess on the card's default device; it must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN,
                        "--steps", "3", "--ckpt-dir", str(workdir / "launcher")],
                       capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    last = (r.stdout.strip().splitlines() or [""])[-1]
    log(f"[train] launcher exit {r.returncode} in {time.perf_counter() - t0:.1f} s: {last}")
    check(r.returncode == 0 and "on cuda" in last,
          f"the train launcher failed: {r.stdout[-500:]} {r.stderr[-1500:]}")
    return {"rc": r.returncode, "last_line": last}


def phase_train() -> dict:
    """Training on the card, after every earlier model is freed: a
    full-width 2-layer f32 step held to the CPU's (:func:`check_train_step`);
    qwen2-0.5b whole through ``Trainer`` with a failure and a resume
    (:func:`train_qwen_whole`); mamba2-780m and whisper-small whole, 10
    steps each; the kernel wrappers under autograd; the train launcher.
    No kernel may launch: training takes the plain paths."""
    release()
    log(f"[train] device memory allocated before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t0 = time.perf_counter()
    ops = kernel_ops()
    n0 = {name: op.launches for name, op in ops.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        workdir = Path(tmp)
        out = {"step_check": check_train_step()}
        release()
        out["qwen2"] = train_qwen_whole(workdir)
        for arch, B, S in TRAIN_ZOO:
            out[arch] = train_zoo_model(arch, B, S, workdir)
        launches = {name: op.launches - n0[name] for name, op in ops.items()}
        check(not any(launches.values()), f"a kernel launched in training: {launches}")
        check_wrappers_refuse_autograd()
        out["launcher"] = run_train_launcher(workdir)
    release()
    out.update(launches=launches, phase_s=round(time.perf_counter() - t0, 1))
    log(f"[train] {json.dumps({'phase_s': out['phase_s'], 'launches': launches})}")
    log(f"[train] {gpu_line()}")
    return out


# ------------------------------------------------------------------ fit
# the cells run for real after the dry run: each must be predicted to fit
FIT_CELLS = ((QWEN, "decode_32k"), (QWEN, "prefill_32k"), (MAMBA, "prefill_32k"),
             (QWEN, "train_4k"), ("gemma3-4b", "long_500k"))
FIT_MISFITS = (("jamba-v0.1-52b", "decode_32k"), ("mixtral-8x7b", "long_500k"))
FIT_LAUNCHES = {(QWEN, "prefill_32k"): {"flash_attention": 24},
                (MAMBA, "prefill_32k"): {"ssd_scan": 48}}
FIT_PEAK_TOL = 0.10           # predicted peak within 10 % of the card's
FIT_FAR_QUERIES = 512         # right-aligned queries of the plain flash check
# rank 0 of these run on the card over the fake process group: (arch,
# shape, mesh name) -> the kernel launches its program must make
SHARDED_CELLS = {("qwen3-moe-30b-a3b", "prefill_32k", "16x16"): {"flash_attention": 48},
                 ("gemma3-27b", "decode_32k", "16x16"): {},
                 ("jamba-v0.1-52b", "prefill_32k", "2x16x16"):
                     {"flash_attention": 4, "ssd_scan": 28}}
FIT_FLASH = (("qwen2-0.5b", 32, 32768, *QWEN_HEADS), ("gemma-2b", 32, 32768, 8, 1, 256))
FIT_SSD = (32, 32768, 48, 64, 128, 1, 256)   # mamba2 prefill_32k: b, S, H, P, N, G, chunk


def outside_allocator() -> int:
    """Bytes in use on the card that the caching allocator does not hold:
    the CUDA context, loaded modules, library handles."""
    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def fit_args(cell, gen):
    """Real arguments of ``cell.fn`` on the card in the shapes and dtypes of
    its meta ones: the port's seeded init for the weights, AdamW's zeroed
    moments, caches as their specs make them (zeros; -1 in a ring's
    positions), random tokens and labels, decode at the context's last
    position."""
    from repro_torch.models import params as P
    from repro_torch.training import optimizer as OPT

    cfg, shape = cell.cfg, cell.shape
    specs = cell.model.param_specs()
    params = P.init(gen, specs, DEV)

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device=DEV,
                                 dtype=torch.int32)
        return (torch.randn(t.shape, generator=gen, device=DEV) * 0.02).to(t.dtype)

    if shape.kind == "decode":
        _, tokens, _, caches = cell.args
        real_caches = P.init(None, cell.model.cache_specs(shape.global_batch,
                                                          shape.seq_len), DEV)
        for r, m in zip(P.tree_leaves(real_caches), P.tree_leaves(caches)):
            check(r.shape == m.shape and r.dtype == m.dtype, "cache specs differ")
        pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int32,
                         device=DEV)
        return params, real(tokens), pos, real_caches
    batch = {k: real(v) for k, v in cell.args[-1].items()}
    if shape.kind == "train":
        return params, OPT.init_opt_state(specs, DEV), batch
    return params, batch


def fit_args_sharded(cell, gen):
    """Real local shards of one device on the card
    (``build.real_local_args``: weights drawn at 0.02, caches empty,
    decode at the context's last position)."""
    from repro_torch.launch.build import real_local_args

    return real_local_args(cell, DEV, gen)


def fit_run(cell, rec, make_args=fit_args, want=None) -> dict:
    """One call of the cell's step on the card, its weights, state and
    inputs allocated inside the window: the peak of
    ``max_memory_allocated`` over what was allocated before, beside the
    dry run's prediction; the call's wall by CUDA events; kernel launches
    (exactly ``want`` where given).  The garbage collector is held off, as
    in the trace."""
    ops = kernel_ops()
    release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gc.disable()
    try:
        args = make_args(cell, torch.Generator(device=DEV).manual_seed(SEED))
        n0 = {name: op.launches for name, op in ops.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = cell.fn(*args)
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {name: op.launches - n0[name] for name, op in ops.items()}
        result = out[2]["loss"] if cell.shape.kind == "train" else out[1]   # logits
        finite = bool(torch.isfinite(result).all())
        del args, out, result
    finally:
        gc.enable()
    release()
    pred = rec["memory"]["peak_bytes"]
    flops = rec.get("traced", {}).get("flops", rec["flops_per_device"])
    nbytes = rec.get("traced", {}).get("bytes", rec["bytes_per_device"])
    wall = start.elapsed_time(end)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    row = {"cell": f"{cell.cfg.name} {cell.shape.name}"
                   + (f" {rec['mesh']} rank 0" if cell.spmd is not None else ""),
           "predicted_gib": round(pred / 2**30, 3), "measured_gib": round(peak / 2**30, 3),
           "ratio": round(pred / peak, 4), "wall_ms": round(wall, 2),
           "flops": flops, "bytes": nbytes, "bound_ms": round(b_ms, 3), "bound_by": b_by,
           "share_of_bound": round(b_ms / wall, 4), "launches": launches,
           "predicted_launches": rec["kernels"]}
    if cell.traced_microbatches:
        row["rows"] = cell.args[-1]["tokens"].shape[0]
    if cell.spmd is not None:
        row["collectives"] = rec["collectives"]
    log(f"[fit] {json.dumps(row)}")
    check(finite, f"{row['cell']}: the step's output is not finite")
    check(abs(pred / peak - 1) <= FIT_PEAK_TOL,
          f"{row['cell']}: predicted peak {pred} B against {peak} B measured")
    if want is None:
        want = FIT_LAUNCHES.get((cell.cfg.name, cell.shape.name), {})
    check(launches == {k: rec["kernels"].get(k, 0) for k in launches}
          and all(launches[k] == n for k, n in want.items()),
          f"{row['cell']}: launches {launches}, the dry run's {rec['kernels']}, want {want}")
    return row


def fit_far_row_flash(label, B, S, H, KV, d, gen, worst, window=0) -> dict:
    """Flash at a prefill shape (past 2^31 elements at gemma-2b's
    prefill_32k): the last batch row bit-equal to a one-row call on that
    row, that call's last ``FIT_FAR_QUERIES`` queries within the bf16 bar
    of the plain version against all S keys; kernel and cuDNN's causal SDPA
    (none with a window) timed."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dt = torch.bfloat16
    q = torch.randn((B, S, H, d), generator=gen, device=DEV, dtype=dt)
    k = torch.randn((B, S, KV, d), generator=gen, device=DEV, dtype=dt)
    v = torch.randn((B, S, KV, d), generator=gen, device=DEV, dtype=dt)
    out = flash_ops.attention(q, k, v, window=window)
    one = flash_ops.attention(q[-1:], k[-1:], v[-1:], window=window)
    torch.cuda.synchronize()
    same = torch.equal(out[-1:], one)
    n = FIT_FAR_QUERIES
    ref = attention_ref(q[-1:, -n:].transpose(1, 2), k[-1:].transpose(1, 2),
                        v[-1:].transpose(1, 2), window=window).transpose(1, 2)
    err, ok = max_err(one[:, -n:], ref, TOL[("flash", dt)])
    worst["flash_attention"] = max(worst["flash_attention"], err)
    del out, one, ref
    ms = cuda_ms(lambda: flash_ops.attention(q, k, v, window=window), iters=3, warmup=1)
    lib = None
    if not window:
        try:
            lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True), iters=3, warmup=1)
        except torch.OutOfMemoryError:
            pass
    b_ms, b_by = bound(*flash_ops.work(B, S, S, H, KV, d, window, 2), dt)
    row = {"kernel": "flash_attention", "shape": f"{label}: B={B} S={S} H={H} "
           f"KV={KV} d={d}" + (f" window={window}" if window else ""),
           "q_elements": q.numel(), "last_row_bit_equal": same,
           "max_abs_err": err, "ms": ms, "library_ms": lib, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": round(b_ms / ms, 4),
           "plain_ms": "not measured: its f32 scores need "
                       f"{B * H * S * S * 4 / 1e9:.1f} GB"}
    log(f"[fit] {json.dumps(row)}")
    del q, k, v
    release()
    check(same, f"flash at {row['shape']}: the last row differs from a one-row call")
    check(ok, f"flash at {row['shape']}: the far row disagrees with its plain version")
    return row


def fit_far_row_ssd(label, b, S, H, P_, N, G, Q, gen, worst, dtype=torch.bfloat16) -> dict:
    """The SSD scan at a prefill shape (x holds 3.2e9 elements at mamba2's
    prefill_32k): the last row's y and h_last bit-equal to a one-row call
    on that row, which is within the plain version's bar (2e-4 at bf16);
    the kernel timed."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    args = ssd_inputs(b, S, H, P_, N, G, dtype, gen)
    y, h = ssd_ops.ssd_scan(*args, chunk=Q)
    last = [t[-1:] for t in args]
    y1, h1 = ssd_ops.ssd_scan(*last, chunk=Q)
    torch.cuda.synchronize()
    same = torch.equal(y[-1:], y1) and torch.equal(h[-1:], h1)
    del y, h
    yr, hr = ssd_scan_ref(*last, chunk=Q)
    (ey, oky), (eh, okh) = max_err(y1, yr, TOL[("ssd", dtype)]), \
        max_err(h1, hr, TOL[("ssd", dtype)])
    worst["ssd_scan"] = max(worst["ssd_scan"], ey, eh)
    del y1, h1, yr, hr
    ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, chunk=Q), iters=3, warmup=1)
    b_ms, b_by = bound(*ssd_ops.work(b, S, H, P_, N, G, Q, args[0].element_size()),
                       dtype)
    row = {"kernel": "ssd_scan", "shape": f"{label}: b={b} S={S} H={H} "
           f"P={P_} N={N} G={G}", "x_elements": args[0].numel(), "last_row_bit_equal": same,
           "max_abs_err": max(ey, eh), "ms": ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": round(b_ms / ms, 4)}
    log(f"[fit] {json.dumps(row)}")
    del args
    release()
    check(same, f"ssd_scan at {label}: the last row differs from a one-row call")
    check(oky and okh, f"ssd_scan at {label}: the far row disagrees with its plain version")
    return row


def kernel_calls(fn):
    """``fn()`` with the models' kernel entry points wrapped to record the
    distinct shapes they are called at -> (fn's result, flash calls
    (B, S, H, KV, d, window), SSD calls (b, S, H, P, N, G, chunk, dtype)),
    each in the order of its first call."""
    from unittest import mock

    from repro_torch.models import lm, mamba

    flash, ssd = {}, {}
    flash_fn, ssd_fn = lm.flash_attention, mamba.ssd_scan

    def flash_rec(q, k, v, *, causal=True, window=0, **kw):
        check(causal and q.shape[1] == k.shape[1], "flash: a sharded prefill's call "
              f"is causal over its own keys, got q {tuple(q.shape)} k {tuple(k.shape)}")
        flash[(*q.shape[:3], k.shape[2], q.shape[3], window)] = None
        return flash_fn(q, k, v, causal=causal, window=window, **kw)

    def ssd_rec(x, B, C, dt, da, *, chunk):
        ssd[(*x.shape, B.shape[3], B.shape[2], chunk, x.dtype)] = None   # N, G
        return ssd_fn(x, B, C, dt, da, chunk=chunk)

    with mock.patch.object(lm, "flash_attention", flash_rec), \
            mock.patch.object(mamba, "ssd_scan", ssd_rec):
        out = fn()
    return out, list(flash), list(ssd)


def fit_sharded(worst) -> tuple[list, list]:
    """Rank 0 of ``SHARDED_CELLS`` on the card: each cell's dry run on its
    pod mesh (meta, the fake process group at the mesh's world size)
    predicts the card's peak, launches and collective bytes; then rank 0's
    program runs once at full width on its real shards, its mesh a CUDA
    one over the same fake group (collectives allocate their outputs and
    move nothing).  Fails if a prediction misses by more than
    ``FIT_PEAK_TOL`` or a launch count differs.  The collectives compute
    nothing, so the cell's values say little: each kernel is then run at
    every local shape the dry run called it at, and held to its plain
    version as the far rows are.  Returns (the cells' rows, the kernels'
    rows)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch.build import build_cell

    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    rows, kernels = [], []
    for (arch, shape, mesh_name), want in SHARDED_CELLS.items():
        mesh = dryrun.MESHES[mesh_name]()
        with M.fake_world(mesh.size):
            rec, flash, ssd = kernel_calls(
                lambda: dryrun.run_cell(arch, shape, mesh, mesh_name, verbose=False))
            check(rec["status"] == "ok", f"dry run of {arch} {shape} {mesh_name}: {rec}")
            check(rec["fits_hbm"], f"{arch} {shape} {mesh_name} is predicted not to fit "
                                   "a card")
            log(f"[sharded] predicted {arch} {shape} {mesh_name} rank 0: peak "
                f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB, collectives "
                f"{json.dumps(rec['collectives'])}, trace {rec['trace_s']} s, "
                f"flash at {flash}, ssd_scan at {[c[:-1] for c in ssd]}")
            cell = build_cell(get_config(arch), SHAPES[shape], mesh, device_type="cuda")
            row = fit_run(cell, rec, fit_args_sharded, want)
            log(f"[sharded] {gpu_line()}: {row['cell']} peak predicted "
                f"{row['predicted_gib']} GiB, measured {row['measured_gib']} GiB "
                f"(ratio {row['ratio']}), wall {row['wall_ms']} ms")
            rows.append(row)
            del cell
        release()
        check(bool(flash) == bool(want.get("flash_attention"))
              and bool(ssd) == bool(want.get("ssd_scan")),
              f"{arch} {shape} {mesh_name}: kernel shapes flash {flash}, ssd {ssd}, "
              f"want {want}")
        label = f"{arch} {shape} {mesh_name} rank 0"
        kernels += [fit_far_row_flash(label, *c[:5], gen, worst, window=c[5]) for c in flash]
        kernels += [fit_far_row_ssd(label, *c[:7], gen, worst, dtype=c[7]) for c in ssd]
    return rows, kernels


def phase_fit(worst) -> dict:
    """The production fit check: the dry run (``launch/dryrun.py``, meta
    device) predicts each cell's peak; the cells predicted to fit run once
    for real at full width, and each prediction is held to the card's
    ``max_memory_allocated`` within ``FIT_PEAK_TOL``; two cells must be
    predicted not to fit.  Then both kernels past 2^31 elements, and rank 0
    of three cells on the reference's pod meshes (:func:`fit_sharded`)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch.build import build_cell

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[fit] {gpu_line()}: total_memory {total:,} B, mesh.HBM_BYTES {M.HBM_BYTES:,} B")
    check(M.HBM_BYTES == total, f"mesh.HBM_BYTES {M.HBM_BYTES} is not the card's {total}")
    mesh = M.make_production_mesh()
    recs = {}

    def predict(arch, shape) -> bool:
        rec = dryrun.run_cell(arch, shape, mesh, "h100", verbose=False)
        check(rec["status"] == "ok", f"dry run of {arch} {shape}: {rec}")
        recs[arch, shape] = rec
        log(f"[fit] predicted {arch} {shape}: peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB, fits {rec['fits_hbm']}, "
            f"trace {rec['trace_s']} s")
        return rec["fits_hbm"]

    for key in FIT_MISFITS:
        check(not predict(*key), f"{key} is predicted to fit one card")
    for key in FIT_CELLS:
        check(predict(*key), f"{key} is predicted not to fit one card")
    release()
    context = [outside_allocator()]
    # segments that grow by mapping pages, for this phase only: under the
    # default allocator mamba2-780m prefill_32k (68.5 GiB allocated at its
    # peak) found 13.7 GiB free in pieces and no 12 GiB block
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        ops = kernel_ops()
        n0 = {name: op.launches for name, op in ops.items()}
        rows = [fit_run(build_cell(get_config(arch), SHAPES[shape], mesh),
                        recs[arch, shape]) for arch, shape in FIT_CELLS]
        launches = {name: op.launches - n0[name] for name, op in ops.items()}
        gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
        far = [fit_far_row_flash(f"{arch} prefill_32k", *dims, gen, worst)
               for arch, *dims in FIT_FLASH]
        far.append(fit_far_row_ssd("mamba2-780m prefill_32k", *FIT_SSD, gen, worst))
        context.append(outside_allocator())
        sharded, sharded_far = fit_sharded(worst)
        context.append(outside_allocator())
        # the cells' own launches: the far rows' comparisons do not count
        sharded_launches = {name: sum(r["launches"][name] for r in sharded)
                            for name in ops}
    finally:
        release()
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")
    log(f"[fit] {gpu_line()}: held outside the allocator {context} B (before the "
        f"cells, after the far rows, after the sharded cells), mesh.CONTEXT_BYTES "
        f"{M.CONTEXT_BYTES:,} B")
    check(max(context) <= M.CONTEXT_BYTES,
          f"the card holds {max(context)} B outside the allocator, more than "
          f"mesh.CONTEXT_BYTES {M.CONTEXT_BYTES}")
    out = {"cells": rows, "far_rows": far, "launches": launches,
           "sharded": sharded, "sharded_far_rows": sharded_far,
           "sharded_launches": sharded_launches,
           "outside_allocator_bytes": context,
           "phase_s": round(time.perf_counter() - t0, 1)}
    log(f"[fit] {json.dumps({'phase_s': out['phase_s'], 'launches': launches, 'sharded_launches': sharded_launches})}")
    return out


def step_vs_bound(cfg, prof, bound=None) -> dict:
    """A profiled decode step (:func:`profile_decode`) beside the least time
    it can take: ``bound`` (ms, bytes), by default every weight read once at
    3.35 TB/s (:func:`weight_read_bound_ms`)."""
    bound_ms, wbytes = bound or weight_read_bound_ms(cfg)
    dev_ms = prof["decode_step_device_ms"]
    return {"decode_step_device_ms": dev_ms,
            "decode_step_wall_ms": prof["decode_step_wall_ms"],
            "busy_share": prof["device_busy_share"],
            "bytes_read_once": wbytes, "step_bound_ms": round(bound_ms, 3),
            "device_over_bound": (round(dev_ms / bound_ms, 3)
                                  if isinstance(dev_ms, float) else "not measured"),
            "wall_over_bound": round(prof["decode_step_wall_ms"] / bound_ms, 3)}


def log_engine(prof, mamba) -> None:
    """Engine-level numbers, a report: the qwen2 paged decode step's device
    time by op and the mamba2 serving run's prefill seconds."""
    ops = [(k[:48], ms, n) for k, ms, n in prof["top_ops_ms_per_step_and_calls"][:5]]
    log(f"[engine] qwen2 paged decode step device ms {prof['decode_step_device_ms']} "
        f"(wall {prof['decode_step_wall_ms']}), port kernels "
        f"{json.dumps(prof['port_kernels_ms_per_step_and_calls'])}, by op "
        f"{json.dumps(ops)}; mamba2 serving prefill {mamba['prefill_s']} s of "
        f"{mamba['wall_s']} s wall, {mamba['launches']['ssd_scan']} SSD-scan launches")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t0 = time.perf_counter()
    try:
        hgmma = phase_build()
        rows = phase_kernels()
        for name, n in hgmma.items():
            rows[name]["hgmma"] = n
        stats = phase_qwen()
        stats["mamba2"] = phase_mamba()
        log_engine(stats["decode_profile"], stats["mamba2"])
        stats["cluster"] = phase_cluster()
        stats["stages"] = phase_stages()
        stats["examples"] = phase_examples()
        worst = {name: rows[name]["max_abs_err"] for name in rows}
        stats["family"] = phase_gemma_family(worst)
        stats["moe"] = phase_moe()
        stats["gemma3"] = phase_gemma3(worst)
        stats["zoo"] = phase_zoo(worst)
        stats["train"] = phase_train()
        stats["fit"] = phase_fit(worst)
        for name, err in worst.items():
            rows[name]["max_abs_err"] = err
        rows["flash_attention"]["gemma3"] = stats["gemma3"]["flash"]
        rows["flash_attention"]["gemma_family"] = stats["family"]["flash"]
        rows["paged_attention"]["gemma_family"] = stats["family"]["paged"]
        rows["flash_attention"]["zoo"] = stats["zoo"]["flash"]
        rows["ssd_scan"]["jamba"] = stats["zoo"]["ssd"]
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                "launches": stats[phase]["launches"][name],
                "cluster_launches": stats["cluster"]["launches"][name],
                "stages_launches": stats["stages"]["launches"][name],
                "gemma_family_launches": stats["family"]["launches"][name],
                "moe_launches": stats["moe"]["launches"][name],
                "gemma3_launches": stats["gemma3"]["launches"][name],
                "zoo_launches": stats["zoo"]["launches"][name],
                "train_launches": stats["train"]["launches"][name],
                "fit_launches": stats["fit"]["launches"][name],
                "sharded_launches": stats["fit"]["sharded_launches"][name],
                **rows[name]}
               for name, replaces, phase in KERNELS]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
