"""minedges_share.static (layer: single-device engine; moves
solve_edges_per_s): the share of the window (%) in which the card ran
MINEDGES, the endpoint gathers and ``min_edge_per_component`` of each
Borůvka round: the seconds between the CUDA events the program records
around each ``static.minedges`` span, summed over the window's spans,
over the window.  None without a card or without the program's
recorder."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    w, trace = run.window, inside.recorded(run)
    s = inside.event_seconds(trace, "static.minedges", w.start_ns, w.end_ns)
    if not w.done or s is None:
        return None
    n = len(inside.spans_of(trace, "static.minedges"))
    run.note(f"minedges_share.static: {s:.6f} s on the card over {n} "
             "rounds")
    return 100.0 * s / w.seconds
