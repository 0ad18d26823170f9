"""MoE layer (``models/layers.py``): device milliseconds of the expert
products (``aten::bmm`` on (E, D, F) or (E, F, D) weights) per step of
the profiled slice."""


def read(run):
    sl = run.slice
    if sl is None or sl.expert_bmm_s is None or not sl.expert_bmm_s or not sl.steps:
        return None
    return sl.expert_bmm_s * 1e3 / len(sl.steps)
