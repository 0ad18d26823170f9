"""The device: the share of the profiled slice in which no operation ran
on the card (one less the union of its activity over the slice), in
percent."""


def read(run):
    sl = run.slice
    if sl is None or sl.wall_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
