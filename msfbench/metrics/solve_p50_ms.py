"""solve_p50_ms (layer: single-device engine): the median of the
window's per-solve latencies, a steadier companion of solve_p95_ms."""
from msfbench.harness.stats import percentile


def read(run):
    lat = [d.latency * 1e3 for d in run.window.served()]
    return percentile(lat, 0.5) if lat else None
