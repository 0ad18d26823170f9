"""Set-up: from the first line of ``run.py`` to the window's start:
loading, drawing the weights, building the engine and the kernels'
libraries (a checkout's first run), warming every shape, a closed loop's
ramp to its clients."""


def read(run):
    return run.setup_s
