"""Paged decode kernel (``kernels/paged_attention``): the least time the
profiled slice's paged decode attention could take on the card (its bytes
at 3.35 TB/s or its operations at 989 TFLOP/s, whichever is longer),
counted once from the contexts the harness knows, over the kernel's
device time, in percent."""
from portbench.harness import peaks, work

KERNEL = "paged_decode_kernel"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    t = sum(s for name, s in sl.kernel_s.items() if KERNEL in name)
    if t <= 0:
        return None
    least = 0.0
    for i in sl.steps:
        ctx = run.steps[i].decode_ctx
        if ctx:
            least += peaks.bound_s(*work.paged_attention_work(run.conf, ctx))[0]
    return 100.0 * least / t
