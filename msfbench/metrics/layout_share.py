"""layout_share (layer: host layout): the share of the window spent in
``build_dist_graph``, the host's doubled, sorted, padded layout of each
request's edges, wherever the public API or the gateway calls it."""
from msfbench.harness.stats import span_share

SITES = ("repro_torch.core.mst:build_dist_graph",
         "repro_torch.serve.msf_gateway:build_dist_graph")


def install(run):
    run.spans.wrap("layout", SITES)


def read(run):
    return span_share(run, "layout")
