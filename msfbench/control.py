"""The control: the plain reference in bfloat16, put in the program's place.

    python3 msfbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10

For each seed, one window of the cell's own traffic at the cell's own
sizes is served by ``reference/msf.py`` on weights rounded to bfloat16
(the precision below the configuration's float32), and its answers are
compared as a benchmark run compares the program's.  Each seed prints
one JSON line with the compared numbers; ``correct`` has to come out
false on every seed.  The smallest reading of each number over the
seeds is the upper reading its limit is set below.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from msfbench.harness import bench
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.run_cell(args.workload, seed, args.seconds, False,
                           control=True, root=ROOT)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
