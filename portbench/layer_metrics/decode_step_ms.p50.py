"""Decode path (``serving/engine.py`` + ``models/lm.py``): median host time
of the window's steps that only decoded, each ended by a synchronise,
outside the profiled slice."""
from portbench.harness import stats


def read(run):
    return stats.percentile(run.step_ms(chunk=False), 50)
