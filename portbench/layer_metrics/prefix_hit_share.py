"""Prefix cache (``serving/prefix_cache.py``): prompt tokens served from
cached blocks over the prompt tokens of the requests admitted in the
window, in percent (a count)."""


def read(run):
    adm = [r.req for r in run.reqs.values()
           if r.req.t_admit is not None and run.in_window(r.req.t_admit)]
    total = sum(len(q.prompt) for q in adm)
    if not total:
        return None
    return 100.0 * sum(q.prefix_hit_tokens for q in adm) / total
