"""MSF serving launcher: the plan-LRU, batching gateway loop.

Port of ``repro/launch/serve_msf.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve_msf --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_msf \\
        --requests 100 --sizes 512,1024 --slots 4 --check

Generates a synthetic traffic mix of gnm / rgg2d graphs over a few
shapes, serves it through ``serve/msf_gateway.py`` over ``--shards``
stacked shards on ``--device`` (the CUDA card by default; ``cpu`` runs
the plain PyTorch paths), and reports requests/s, latency percentiles
and the plan-cache hit / replan accounting.  ``--check`` holds every
served forest to the Kruskal oracle's edge set.  ``--pallas-minedges``
routes the MINEDGES reductions through K1.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence


def make_traffic(families: Sequence[str], sizes: Sequence[int],
                 requests: int, seed: int = 0,
                 avg_degree: float = 8.0) -> List["MSFRequest"]:
    """A synthetic serving mix: ``requests`` graphs cycling over the
    (family, n) grid with per-request seeds, so shapes repeat (plan-cache
    hits) while contents differ (real solves)."""
    from repro_torch.data import generators
    from repro_torch.serve.msf_gateway import MSFRequest
    shapes = [(f, n) for f in families for n in sizes]
    out = []
    for i in range(requests):
        fam, n = shapes[i % len(shapes)]
        u, v, w, n = generators.generate(fam, n, avg_degree=avg_degree,
                                         seed=seed + i)
        out.append(MSFRequest(rid=i, family=fam, u=u, v=v, w=w, n=n))
    return out


def percentile(xs: Sequence[float], q: float) -> float:
    ys = sorted(xs)
    if not ys:
        return 0.0
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny mix, asserts hit rate + oracle identity")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--families", default="gnm,rgg2d")
    ap.add_argument("--sizes", default="512,1024")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-size", type=int, default=8)
    ap.add_argument("--pad-margin", type=float, default=0.25)
    ap.add_argument("--algorithm", default="boruvka")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=8,
                    help="stacked shards the engine runs over")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--pallas-minedges", action="store_true",
                    help="MINEDGES reductions through the K1 kernel")
    ap.add_argument("--check", action="store_true",
                    help="verify every forest against the Kruskal oracle")
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.serve.msf_gateway import MSFGateway

    if args.smoke:
        args.requests = min(args.requests, 24)
        args.sizes = "256"
        args.check = True

    gw = MSFGateway(args.shards, device=args.device,
                    algorithm=args.algorithm, cache_size=args.cache_size,
                    batch_slots=args.slots, pad_margin=args.pad_margin,
                    pallas_minedges=args.pallas_minedges)
    reqs = make_traffic(args.families.split(","),
                        [int(s) for s in args.sizes.split(",")],
                        args.requests, seed=args.seed)
    t0 = time.perf_counter()
    for r in reqs:
        gw.submit(r)
    gw.run()
    dt = time.perf_counter() - t0

    assert all(r.done for r in reqs)
    if args.check:
        from repro_torch.core import oracle
        for r in reqs:
            kmask, kweight = oracle.kruskal(r.u, r.v, r.w, r.n)
            assert np.array_equal(r.edges, np.nonzero(kmask)[0]), \
                f"request {r.rid}: forest != oracle"
        print(f"oracle check: {len(reqs)} forests bit-identical")

    lat = [r.latency for r in reqs]
    s = gw.stats
    print(f"{len(reqs)} requests in {dt:.2f}s ({len(reqs) / dt:.2f} req/s, "
          f"{s.batches} batches)")
    print(f"latency p50={percentile(lat, 0.50):.3f}s "
          f"p99={percentile(lat, 0.99):.3f}s")
    print(f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(hit rate {s.hit_rate:.2f}), {s.evictions} evictions, "
          f"{s.replans} replans (rate {s.replan_rate:.2f}), "
          f"{s.refreshes} refreshes")
    if args.smoke:
        assert s.hit_rate > 0.5, f"smoke hit rate {s.hit_rate:.2f} <= 0.5"
        print("SMOKE OK")


if __name__ == "__main__":
    main()
