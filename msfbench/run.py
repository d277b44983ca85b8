"""Run one cell of the benchmark once and print its result line.

    python3 msfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``src/repro_torch``), on a machine with as many CUDA
cards as the cell asks for.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last:
each number compared with its limit); the compared numbers are also the
last lines of standard error.  The exit code is not 0, and no result is
printed, where there is no card, too few cards, no program, or where
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program builds stays inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from msfbench.harness import bench, cell

    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 2
    chips = cell.load_cell(args.workload, ROOT).chips
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards and "
              f"{torch.cuda.device_count()} are here", file=sys.stderr)
        return 2

    result = bench.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START, root=ROOT)
    found = bench.forbidden_modules()
    if found:
        print("loaded, and forbidden in a benchmark run: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in result.pop("_notes"):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
