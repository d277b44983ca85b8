"""prep_forest_share.sharded (layer: local preprocessing; moves
sharded_edges_per_s): the share (%) of the forest edges of the window's
sharded solves that the local preprocessing contracted: the program's
counter ``prep.forest_edges`` over ``sharded.forest_edges``, each summed
over the window.  None without the program's recorder or its
counters."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    trace = inside.recorded(run)
    if trace is None:
        return None
    prep = trace.counters.get("prep.forest_edges")
    forest = trace.counters.get("sharded.forest_edges")
    if prep is None or not forest:
        return None
    run.note(f"prep_forest_share.sharded: {prep} of {forest} forest edges "
             "contracted by the preprocessing")
    return 100.0 * prep / forest
