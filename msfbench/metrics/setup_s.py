"""setup_s: seconds from process start to the window's start (the pool
of graphs, the system, its warm-up; a first run in a checkout also
builds the kernels)."""


def read(run):
    return run.setup_s
