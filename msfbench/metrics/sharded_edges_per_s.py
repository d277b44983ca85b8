"""sharded_edges_per_s: the input edges (m of each request) of every
request the window served through the sharded engine, over the time from
the window's start to the last completion."""
from msfbench.harness.stats import served_rate


def read(run):
    return served_rate(run)
