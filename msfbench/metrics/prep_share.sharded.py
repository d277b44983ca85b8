"""prep_share.sharded (layer: local preprocessing; moves
sharded_edges_per_s): the share of the window (%) under the program's
``sharded.prep`` spans, the body of ``_sharded_preprocess`` (the
paper's contraction of each shard's local parts before the rounds)
wherever the sharded engine calls it.  Its note gives the card's
seconds between the span's CUDA events and the rounds a preprocessing.
None without the program's recorder or its span."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    share = inside.span_share(run, "sharded.prep")
    if share is None:
        return None
    w, trace = run.window, inside.recorded(run)
    n = len(inside.spans_of(trace, "sharded.prep"))
    card = inside.event_seconds(trace, "sharded.prep", w.start_ns, w.end_ns)
    rounds = trace.counters.get("prep.rounds", 0)
    run.note(f"prep_share.sharded: {n} preprocessings, "
             f"{rounds / n:.3f} rounds each, "
             + ("not timed on a card" if card is None
                else f"{card:.6f} s on the card"))
    return share
