"""device_idle.sharded (layer: device; moves sharded_edges_per_s): the share
of the traced window in which no operation ran on the card (one minus
the union of the profiler's kernel, copy and memset intervals over it)."""
from msfbench.harness.stats import idle_share


def read(run):
    return idle_share(run)
