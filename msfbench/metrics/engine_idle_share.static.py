"""engine_idle_share.static (layer: single-device engine; moves
solve_edges_per_s): the share of the traced window (%) in which the card
was idle while the host was inside a static solve: the idle gaps of the
profiler's trace whose middle lies under the program's ``static.solve``
span, over the traced window.  Its note splits those seconds by the
innermost program span (``static.sort``, ``static.minedges``,
``static.contract``, ``static.relabel``, ``static.sync``, the rest of
``static.round``, the rest of ``static.solve``) and gives the mean
rounds a solve.  None without a device trace or the program's
recorder."""
from msfbench.harness import inside


def install(run):
    inside.install(run)


def read(run):
    trace = inside.recorded(run)
    by = inside.idle_under(trace, run.devtrace, "static.solve")
    if by is None:
        return None
    solves = len(inside.spans_of(trace, "static.solve"))
    rounds = trace.counters.get("static.rounds", 0)
    split = ", ".join(f"{k} {v:.6f}" for k, v in
                      sorted(by.items(), key=lambda kv: -kv[1]))
    run.note(f"engine_idle_share.static: idle s by program span: {split}; "
             f"{rounds / max(solves, 1):.3f} rounds a solve")
    return 100.0 * sum(by.values()) / run.devtrace.window_s
