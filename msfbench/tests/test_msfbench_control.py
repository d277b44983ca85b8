"""The comparison that decides ``correct`` has to fail what is wrong.

On the CPU at a small size: the control (the plain reference in
bfloat16 in the program's place) and, for each cell, a run with the
timed path broken underneath as the window opens, with the faults each
cell can have.  The harness's look for a card is skipped; the rest of a
run, the comparison with the reference included, is the benchmark's."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from msfbench.harness import bench  # noqa: E402

torch.set_num_threads(1)
SMALL = {"gnm20-p8": {"n": 1024, "m": 8192, "warm_shrink": 4},
         "rmat19-p1": {"scale": 10}}
CELLS = ("gnm20-p8.served", "rmat19-p1.boruvka", "gnm20-p8.oneshot",
         "rmat19-p1.filter")


@pytest.fixture
def run(bench_root):
    def go(cell, seed=11, **kw):
        return bench.run_cell(
            cell, seed, 1.0, False, device="cpu", root=bench_root,
            overrides={"config": SMALL[cell.split(".")[0]]}, **kw)
    return go


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, run):
    r = run(cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed, run):
    r = run(cell, seed, control=True)
    assert not r["correct"]
    # the control has to fail one of the numbers (at this small size its
    # forest may come out equal to the reference's; its weight does not)
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _patch(site, make):
    """A window-start hook that puts ``make(original)`` at ``site`` for the
    rest of the run (the harness's ``Spans`` puts it back)."""
    return lambda r: r.spans.replace(site, make)


def _flip(mask):
    out = mask.clone()
    out.view(-1)[0] = ~out.view(-1)[0]
    return out


def _unchanged_round(fn):
    def step(u, v, w, labels, mst, n, *a, **kw):
        return labels, mst, torch.tensor(False)
    return step


def _unchanged_sharded_round(fn):
    def body(*args, **kw):
        out = fn(*args, **kw)
        lab, mst, dead = args[5], args[6], args[7]
        return (lab, mst, dead) + tuple(out[3:])
    return body


def _no_exchange(fn):
    def a2a(x, *a, **kw):
        return x.contiguous()  # every buffer stays with its sender
    return a2a


def _altered_answer(fn):
    def solve(*a, **kw):
        out = fn(*a, **kw)
        return (_flip(out[0]),) + tuple(out[1:])
    return solve


def _half_batch(fn):
    def batched(graphs, *a, **kw):
        keep = max(1, len(graphs) // 2)
        results, flagged = fn(graphs[:keep], *a, **kw)
        return list(results) + [None] * (len(graphs) - keep), flagged
    return batched


def _altered_batch(fn):
    def batched(*a, **kw):
        results, flagged = fn(*a, **kw)
        results = list(results)
        if results[0] is not None:
            results[0] = (_flip(results[0][0]),) + tuple(results[0][1:])
        return results, flagged
    return batched


DS = "repro_torch.core.distributed_sharded:_round_body"
A2A = "repro_torch.comm.exchange:all_to_all_nd"
GW = "repro_torch.serve.msf_gateway:execute_plan_batched"
FAULTS = {
    "rmat19-p1.boruvka": {
        "state unchanged": ("repro_torch.core.boruvka:boruvka_round",
                            _unchanged_round),
        "answer altered": ("repro_torch.core.mst:boruvka_msf",
                           _altered_answer)},
    "rmat19-p1.filter": {
        "state unchanged": ("repro_torch.core.boruvka:boruvka_round",
                            _unchanged_round),
        "answer altered": ("repro_torch.core.mst:filter_boruvka_msf",
                           _altered_answer)},
    "gnm20-p8.oneshot": {
        "state unchanged": (DS, _unchanged_sharded_round),
        "exchange left out": (A2A, _no_exchange),
        "answer altered": ("repro_torch.core.mst:distributed_sharded_msf",
                           _altered_answer)},
    "gnm20-p8.served": {
        "state unchanged": (DS, _unchanged_sharded_round),
        "exchange left out": (A2A, _no_exchange),
        "half of the batch left out": (GW, _half_batch),
        "answer altered": (GW, _altered_batch)},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, run):
    site, make = FAULTS[cell][fault]
    r = run(cell, on_window=_patch(site, make))
    assert not r["correct"], (fault, r["checks"])
