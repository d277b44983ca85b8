"""The port's chaos harness on the CPU: every injected fault detected or
tolerated, never silent, deterministically.

``repro_torch.launch.chaos`` runs the reference's smoke matrix (n = 128,
seed 0, p = 8, gnm and rgg2d, the planned path), its batched cells, the
grid-push cells on a ``(4, 2)`` layout and the recovery cells with
``device="cpu"``.  No cell may be ``SILENT``; two runs give the same
verdicts and the same injected-item counts; the resumed run is
bit-identical to the fault-free one and the elastic p -> p/2 resume is
Kruskal's edge set; a fault-free replay after the matrix equals the one
before it.  The CLI's ``--smoke --device cpu`` prints its OK line.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm import faults
from repro_torch.core import distributed_sharded as ds
from repro_torch.launch import chaos

N, SEED = 128, 0
CPU = "cpu"


def _smoke_cells():
    cells = chaos.run_matrix(("gnm", "rgg2d"), N, SEED, batched=False,
                             verbose=False, device=CPU)
    return cells + chaos.run_grid_push_cells(N, SEED, verbose=False,
                                             device=CPU)


def test_smoke_matrix_is_never_silent_and_deterministic():
    first = _smoke_cells()
    assert len(first) == 2 * len(chaos.FAULT_MATRIX) + len(
        chaos.GRID_FAULT_MATRIX)
    assert not [c for c in first if c["verdict"] == "SILENT"], first
    assert {c["verdict"] for c in first} <= {"detected", "tolerated"}
    # every cell that ran to its end injected something
    assert all(c["injected_items"] > 0 for c in first
               if c["injected_items"] >= 0)
    second = _smoke_cells()
    assert [(c["verdict"], c["injected_items"], c["why"]) for c in first] \
        == [(c["verdict"], c["injected_items"], c["why"]) for c in second]
    assert faults.active() is None


def test_batched_cells_are_never_silent():
    cells = chaos.run_matrix(("gnm",), N, SEED, batched=True,
                             verbose=False, device=CPU)
    batched = [c for c in cells if c["path"] == "batched"]
    assert len(batched) == len(chaos.FAULT_MATRIX)
    assert not [c for c in cells if c["verdict"] == "SILENT"], cells


def test_recovery_cells_resume_bit_identical():
    cells = chaos.run_recovery_cells(("gnm", "rgg2d"), N, SEED,
                                     verbose=False, device=CPU)
    resume = [c for c in cells if c["cell"] == "resume"]
    elastic = [c for c in cells if c["cell"] == "elastic"]
    assert len(resume) == 2 and len(elastic) == 1
    assert all(c["bit_identical"] and 0 <= c["re_executed_rounds"] <= 2
               and c["ckpt_round"] >= 2 for c in resume)
    assert elastic[0]["oracle_identical"] and elastic[0]["p_to"] == 4


def test_fault_free_replay_is_unperturbed():
    g, km, _, _, _, _ = chaos._build("gnm", N, chaos.NUM_SHARDS, SEED,
                                     torch.device(CPU))
    plan = ds.plan_sharded_msf(g, N, chaos.NUM_SHARDS, **chaos.K1)
    before = ds.execute_plan(g, N, chaos.NUM_SHARDS, plan, replan=False)
    for _, spec in chaos.FAULT_MATRIX:
        chaos._classify(g, N, chaos.NUM_SHARDS, plan, spec, SEED,
                        before[0].numpy(), 0.0, 0)
    after = ds.execute_plan(g, N, chaos.NUM_SHARDS, plan, replan=False)
    for a, b in zip(before[:5], after[:5]):
        assert torch.equal(a, b)
    for a, b in zip(before[5], after[5]):
        assert torch.equal(a, b)
    assert chaos._oracle_identical(g, after[0].numpy(), km)


def test_port_faults_are_not_detections():
    """Only the engine's own errors classify as detected: a bare torch
    error from the engine would be a fault of the port."""
    assert chaos._detected(RuntimeError("plan replay does not fit x"))
    assert chaos._detected(faults.ShardAbort("minedges", 1, 0))
    assert not chaos._detected(RuntimeError("index 9 is out of bounds"))
    assert not chaos._detected(IndexError("index 9 is out of bounds"))


def test_cli_smoke_on_the_cpu(capsys):
    chaos.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "chaos: OK (zero silent corruptions)" in out
    assert "'SILENT': 0" in out and "recovery: 2 cells" in out
    with pytest.raises(SystemExit):
        chaos.main(["--bogus"])
    np.testing.assert_equal(faults.active(), None)
