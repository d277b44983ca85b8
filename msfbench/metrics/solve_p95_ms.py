"""solve_p95_ms: the nearest-rank 95th percentile of all the window's
per-solve latencies (host clock around each public-API call, ending in
``torch.cuda.synchronize()``); the sample count goes to standard error."""
from msfbench.harness.stats import beyond, percentile


def read(run):
    lat = [d.latency * 1e3 for d in run.window.served()]
    if not lat:
        return None
    run.note(f"solve_p95_ms over {len(lat)} solves, "
             f"{beyond(lat, 0.95)} beyond it")
    return percentile(lat, 0.95)
