"""A cell as ``BENCHMARK.json`` names it, found by name in its files.

A cell (an entry of ``workloads``) joins a configuration
(``configs/<config>.json``, the deployment: graph family and size,
engine and its options), a traffic mix (``traffic/<traffic>.json``, the
parameters its driver ``traffic/<entry>.py`` reads) and its limits
(``workloads/<cell>.json``).  Its metrics are the entries of
``end_to_end`` and ``per_layer`` that name it, or that name none and
move a metric it reports; each is read by ``metrics/<metric>.py``.
Nothing here knows a cell, a configuration, a traffic, a graph family or
a metric by name.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import msfbench

BENCH_DIR = msfbench.BENCH_DIR
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run reports: per-layer ones in a traced run."""
        return self.per_layer if trace else self.end_to_end


def reports(metric: dict, cell: str, moved: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moved


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in spec["end_to_end"] if reports(m, name, set())]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, name, moved)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str) -> ModuleType:
    """The module of ``metrics/<metric>.py``."""
    return msfbench.by_name("metrics", metric)
