"""solve_edges_per_s: the input edges (m of each solve) of every solve
the window completed, over the time from the window's start to the last
completion."""
from msfbench.harness.stats import served_rate


def read(run):
    return served_rate(run)
