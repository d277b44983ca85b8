"""sync_share.sharded (layer: sharded engine rounds; moves
sharded_edges_per_s): the share of the window (%) under the program's
``sharded.sync`` spans, every host read of a device value on the path
of ``_shrinking_capacity_msf`` and its rounds (its copies of labels,
dead mask, counters, overflow and ``go``, the final mask; the
preprocessing's and adaptive doubling's flags): the host waiting for
the card's round and copying back.  None without the program's recorder."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    return inside.span_share(run, "sharded.sync")
