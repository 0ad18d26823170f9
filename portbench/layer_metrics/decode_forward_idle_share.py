"""The device inside the decode forward: the profiled slice's device idle
(the union rule of ``device_idle_share``) inside the decode forward's
ranges, over the host length of the engine's ``engine.decode.forward``
spans at the slice's steps, in percent.  The idle is the slice's
``idle_by_host`` under the harness's ``model.decode_step_paged`` range,
the innermost range around the forward that the reduction keeps; the
program's span encloses it."""
from portbench.harness import steps

RANGE = "model.decode_step_paged"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    spans = [steps.phase(sp, steps.FORWARD) for sp in steps.sliced(run)]
    length = sum(s.duration for s in spans if s is not None)
    if length <= 0:
        return None
    return 100.0 * dict(sl.idle_by_host).get(RANGE, 0.0) / length
