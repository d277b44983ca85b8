"""A checkout root for the tests that also holds the served cell.

``gnm20-p8.served`` (the ``gateway`` driver, ``traffic/served.json``,
``workloads/gnm20-p8.served.json`` and its two readers) is kept out of
``BENCHMARK.json`` while the gateway's replans make its rate depend on
the seed; its files stay, so that the cell comes back as entries alone.
The fixture ``bench_root`` is a root whose ``BENCHMARK.json`` adds
those entries, beside this folder, so the tests hold the cell to the
same checks as the others."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SERVED = "gnm20-p8.served"
HELD_BACK = {
    "workload": {"name": SERVED, "config": "gnm20-p8", "traffic": "served",
                 "chips": 1, "why": "test"},
    "per_layer": [
        {"name": "gateway_replan_rate", "unit": "%", "better": "lower",
         "source": "program_counter", "layer": "serving gateway",
         "moves": "sharded_edges_per_s", "workloads": [SERVED]},
        {"name": "replay_share", "unit": "%", "better": "lower",
         "source": "program_span", "layer": "plans and planned replay",
         "moves": "sharded_edges_per_s", "workloads": [SERVED]}],
}


def with_served(spec: dict) -> dict:
    """``spec`` with the served cell and its metrics added."""
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append(HELD_BACK["workload"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gnm20-p8.oneshot" in m.get("workloads", ()):
            m["workloads"].append(SERVED)
    spec["per_layer"] += HELD_BACK["per_layer"]
    return spec


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("root")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(with_served(spec)))
    (root / "msfbench").symlink_to(ROOT / "msfbench")
    return root
