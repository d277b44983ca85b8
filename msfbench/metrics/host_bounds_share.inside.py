"""host_bounds_share.inside (layer: host bounds; moves
sharded_edges_per_s): the share of the window (%) under the program's
own ``host_bounds`` spans: the sharded engine's numpy bounds at their
call sites (a solve's ``_HostGraph`` and flat capacities, the ghost
cache's set-up tables and bounds, each round's root table and caps in
``_shrinking_capacity_msf``).
It reads the work that ``host_bounds_share`` reads from outside, from
spans that a rewrite of the bounds keeps.  None without the program's
recorder."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    return inside.span_share(run, "host_bounds")
