"""gateway_replan_rate (layer: serving gateway): the share of the
window's served requests that the gateway's plan did not fit, so that it
served them through a measured replan (``GatewayStats``)."""

FIELDS = ("served", "replans")


def _snapshot(run):
    return {k: getattr(run.system.stats, k) for k in FIELDS}


def begin(run):
    if hasattr(run.system, "stats"):
        run.counters["gateway_start"] = _snapshot(run)


def read(run):
    if "gateway_start" not in run.counters:
        return None
    start, end = run.counters["gateway_start"], _snapshot(run)
    served = end["served"] - start["served"]
    if not served:
        return None
    return 100.0 * (end["replans"] - start["replans"]) / served
