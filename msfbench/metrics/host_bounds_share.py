"""host_bounds_share (layer: host bounds): the share of the window spent
in the shrinking driver's numpy bounds (the host copy of the layout, the
lookup bound, each round's caps and the ghost cache's tables and
bounds), a call nested in another counted once."""
from msfbench.harness.stats import span_share

_DS = "repro_torch.core.distributed_sharded:"
SITES = tuple(_DS + f for f in (
    "_HostGraph.__init__", "_HostGraph.ghost_table_sizes", "_lookup_bound",
    "_host_round_caps", "_host_ghost_table", "_root_table",
    "_ghost_fill_bounds", "_subscribe_capacity_bound",
    "_push_capacity_bound", "_push_capacity_bound_grid"))


def install(run):
    run.spans.wrap("host_bounds", SITES)


def read(run):
    return span_share(run, "host_bounds")
