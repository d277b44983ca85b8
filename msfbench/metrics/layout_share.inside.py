"""layout_share.inside (layer: host layout; moves sharded_edges_per_s):
the share of the window (%) under the program's own ``layout`` span, the
body of ``build_dist_graph`` (the host's doubled, sorted, padded layout
of each request's edges) wherever it is called.  It reads the work that
``layout_share`` reads from outside, from a span that a rewrite of the
layout keeps.  None without the program's recorder."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    return inside.span_share(run, "layout")
