"""Admission (``serving/scheduler.py``): 90th percentile of the engine
tracer's ``queue_wait`` spans of the requests due in the window.  Submit
and admission are both stamped with the ``now`` the harness passes."""
from portbench.harness import stats


def read(run):
    due = {r.rid for r in run.window_reqs()}
    waits = [s.duration * 1e3 for tr in run.tracer.traces() if tr.rid in due
             for s in tr.spans if s.name == "queue_wait" and not s.open]
    return stats.percentile(waits, 90)
