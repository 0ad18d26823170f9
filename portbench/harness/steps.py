"""The engine's step spans (``repro_torch.core.tracing``; the engine records
every step that runs while a profiler runs, so a traced run's profiled slice
carries them), matched to the harness's step records by the ``now`` each
step was given.  A program that records no step spans gives none, and its
readers then read nothing."""
from __future__ import annotations

FORWARD = "engine.decode.forward"


def recorded(run) -> list:
    """Every kept step: its ``engine.step`` span, then its phases."""
    read = getattr(run.tracer, "step_spans", None)
    return read() if read is not None else []


def sliced(run) -> list:
    """The profiled slice's steps."""
    if run.slice is None:
        return []
    nows = {run.steps[i].t0 for i in run.slice.steps}
    return [sp for sp in recorded(run) if sp[0].attrs.get("now") in nows]


def phase(spans, name: str):
    """The step's phase span named ``name``, or None where it did not run."""
    return next((s for s in spans[1:] if s.name == name), None)
