"""Boundaries of the PyTorch port that hold without a GPU: it imports
nothing of JAX or of the reference package, its entry points refuse to
fall back to the CPU, and ``chip_smoke.py`` fails cleanly where there is
no card or no checkout around it."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.comm.grid_alltoall import all_to_all_nd
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    from repro_torch.core.graph import from_numpy
    z = np.zeros(3, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy(z, z, np.ones(3, np.float32), 4)
    assert from_numpy(z, z, np.ones(3, np.float32), 4,
                      device="cpu").u.device.type == "cpu"
    # the entry points that take built tensors still need the card
    # unless the CPU is named, whatever device the tensors are on
    from repro_torch.core.distributed import build_dist_graph
    from repro_torch.core.distributed_sharded import execute_plan_batched
    from repro_torch.core.plan import synthetic_plan
    from repro_torch.core.verify import verify_forest
    from repro_torch.launch import chaos
    u = np.array([0, 1, 2], np.int32)
    g, _ = build_dist_graph(u, u + 1, np.ones(3, np.float32), 4, 2,
                            device="cpu")
    mask = torch.zeros(g.cap_total, dtype=torch.bool)
    lab = torch.arange(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verify_forest(g, 4, 2, mask, lab)
    rep = verify_forest(g, 4, 2, mask, lab, device="cpu")
    assert rep.ok and rep.components == 4 and rep.count == 0
    plan = synthetic_plan(4, g.cap_total, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_plan_batched([g], 4, 2, plan)
    results, flagged = execute_plan_batched([g], 4, 2, plan, device="cpu")
    assert results[0][0].device.type == "cpu" and int(results[0][2]) == 3
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.main(["--smoke"])
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.chaos",
                           "--smoke"], capture_output=True, text=True,
                          timeout=120, env=_env())
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert "chaos: OK" not in proc.stdout


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [x for x in [env.get("PYTHONPATH")] if x])
    return env


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert "FAILED" in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("sizes", [(1,), (8,), (4, 2), (2, 3), (2, 2, 2)])
def test_all_to_all_grid_equals_direct(sizes):
    """Every schedule delivers chunk (s -> d) to (d <- s)."""
    p = int(np.prod(sizes))
    x = torch.arange(p * p * 3 * 2).view(p, p, 3, 2)
    got = all_to_all_nd(x, sizes, "grid")
    assert torch.equal(got, all_to_all_nd(x, sizes, "direct"))
    assert torch.equal(got, x.transpose(0, 1))
