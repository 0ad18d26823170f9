"""The model's step: model FLOPs of the tokens computed in the profiled
slice over the slice's seconds at 989 TFLOP/s, in percent.  Prompt tokens
served from the prefix cache are not computed; each computed token
counts its weights (the routed experts only) and attention over its
context.  The chunk calls' positions are the engine tracer's
``prefill_chunk[k]`` annotations at the slice's steps."""
from portbench.harness import peaks, work


def read(run):
    sl = run.slice
    if sl is None or not sl.steps:
        return None
    nows = {run.steps[i].t0 for i in sl.steps}
    flops = 0.0
    for i in sl.steps:
        flops += sum(work.token_flops(run.conf, c) for c in run.steps[i].decode_ctx)
    for tr in run.tracer.traces():
        for s in tr.spans:
            if s.name.startswith("prefill_chunk[") and s.t0 in nows:
                p0, n = s.attrs["pos0"], s.attrs["tokens"]
                flops += sum(work.token_flops(run.conf, p + 1) for p in range(p0, p0 + n))
    return 100.0 * flops / (sl.wall_s * peaks.PEAK_FLOPS_BF16)
