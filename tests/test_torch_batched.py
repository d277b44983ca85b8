"""Batched planned replay of the port against the JAX reference, request
by request.

One 8-device JAX subprocess (module-scoped fixture), with
``pallas_minedges=False`` (its kernel path does not run under this JAX,
ROADMAP.md queue 3), on gnm n = 512 (average degree 8, seed 7, p = 8):

  * ``execute_plan_batched`` of the graph and its twin with weights
    shuffled by ``default_rng(1)`` under the first graph's plan padded
    by 0.5, strict, with and without ``verify`` (the plan is the port's,
    whose JSON equals the reference's measurement byte for byte);
  * the unpadded plan on the graph and a gnm graph of another seed with
    the same slot count that the plan does not fit (the first such seed
    from 8 on), under ``replan=True``, ``False`` and ``"defer"``;
  * the batched resume of both padded requests from their checkpoints
    at planned round 3 (``execute_plan(ckpt_every=3)``).

The port runs each batch one request after another through its planned
executor (``pallas_minedges=True``, K1's plain version on the CPU); per
request the mask, weight, count, labels, overflow and every
``CommStats`` field must equal the reference's, and so must the
``flagged`` tuple and the strict mode's error.  ``stack=False`` and the
batched resume's ``CheckpointError`` cases are the port's own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import DistGraph, build_dist_graph
from repro_torch.core.msf_checkpoint import CheckpointError
from repro_torch.core.plan import RoundPlan
from repro_torch.data import generators
from tests.helpers.subproc import run_multidevice

CPU = torch.device("cpu")
N, SEED = 512, 7
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")
RESULT = ("mask", "weight", "count", "labels", "overflow")

REFERENCE = """
from jax.sharding import Mesh
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import (execute_plan,
                                            execute_plan_batched)
from repro.core.plan import RoundPlan
from repro.data import generators

out = {}
mesh = Mesh(np.array(jax.devices()), ("data",))
u, v, w, n = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
g1, cap = build_dist_graph(u, v, w, n, 8)
w2 = np.asarray(w).copy()
np.random.default_rng(1).shuffle(w2)
g2 = build_dist_graph(u, v, w2, n, 8)[0]
plan = RoundPlan.from_json(PLAN)
padded = plan.pad(0.5)
out["plan"] = np.asarray(plan.to_json())
out["padded"] = np.asarray(padded.to_json())


def save_graph(name, g):
    for k in ("u", "v", "w", "eid"):
        out[f"{name}/{k}"] = np.asarray(getattr(g, k))


def save(prefix, results, flagged):
    out[prefix + "/flagged"] = np.asarray(flagged, np.int64)
    for i, res in enumerate(results):
        if res is None:
            out[f"{prefix}/{i}/none"] = np.asarray(True)
            continue
        for nm, x in zip(RESULT, res[:5]):
            out[f"{prefix}/{i}/{nm}"] = np.asarray(x)
        for f in STATS:
            out[f"{prefix}/{i}/stat_{f}"] = np.asarray(getattr(res[5], f))


save_graph("g1", g1)
save_graph("g2", g2)
save("fit", *execute_plan_batched([g1, g2], n, mesh, padded, replan=False))
save("fit_verify", *execute_plan_batched([g1, g2], n, mesh, padded,
                                         replan=False, verify=True))
for seed in range(8, 40):
    uu, vv, ww, _ = generators.generate("gnm", N, avg_degree=8.0, seed=seed)
    if len(uu) != len(u):
        continue
    g3 = build_dist_graph(uu, vv, ww, n, 8, cap=cap)[0]
    results, flagged = execute_plan_batched([g1, g3], n, mesh, plan,
                                            replan="defer")
    if flagged == (1,):
        break
else:
    raise AssertionError("no unfit gnm graph found")
save_graph("g3", g3)
save("defer", results, flagged)
save("replan", *execute_plan_batched([g1, g3], n, mesh, plan, replan=True))
try:
    execute_plan_batched([g1, g3], n, mesh, plan, replan=False)
    out["strict"] = np.asarray("")
except RuntimeError as e:
    out["strict"] = np.asarray(str(e))
cks = []
for g in (g1, g2):
    got = []
    execute_plan(g, n, mesh, padded, replan=False, ckpt_every=3,
                 ckpt_out=got)
    cks.append(got[0])
out["resume_pos"] = np.asarray(cks[0].plan_pos)
save("resumed", *execute_plan_batched([g1, g2], n, mesh, padded,
                                      replan=False, resume_from=cks))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    # the port's plan of the first graph: its JSON is the reference's own
    # measurement byte for byte (tests/test_torch_plan.py), so the
    # subprocess spends no measurement pass
    u, v, w, n = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
    g1 = build_dist_graph(u, v, w, n, 8, device=CPU)[0]
    plan = ds.plan_sharded_msf(g1, n, 8, pallas_minedges=False).to_json()
    path = tmp_path_factory.mktemp("jax_reference_batched") / "ref.npz"
    body = (f"OUT = {str(path)!r}\nN = {N}\nSEED = {SEED}\n"
            f"STATS = {STATS!r}\nRESULT = {RESULT!r}\nPLAN = {plan!r}\n"
            + REFERENCE)
    assert "OK" in run_multidevice(body, ndev=8, timeout=900)
    with np.load(path) as data:
        return dict(data)


def _graph(ref, name):
    return DistGraph.from_numpy(*(ref[f"{name}/{k}"]
                                  for k in ("u", "v", "w", "eid")),
                                device=CPU)


def _plan(ref, name):
    return RoundPlan.from_json(str(ref[name]))._replace(pallas_minedges=True)


def _assert_batch(ref, prefix, results, flagged):
    assert flagged == tuple(int(i) for i in ref[prefix + "/flagged"])
    assert isinstance(flagged, tuple)
    for i, res in enumerate(results):
        if f"{prefix}/{i}/none" in ref:
            assert res is None, (prefix, i)
            continue
        for nm, x in zip(RESULT, res[:5]):
            exp = ref[f"{prefix}/{i}/{nm}"]
            x = x.cpu().numpy()
            assert x.dtype == exp.dtype, (prefix, i, nm)
            np.testing.assert_array_equal(x, exp,
                                          err_msg=f"{prefix} {i} {nm}")
        for f in STATS:
            np.testing.assert_array_equal(
                getattr(res[5], f).numpy(), ref[f"{prefix}/{i}/stat_{f}"],
                err_msg=f"{prefix} {i} {f}")


@pytest.mark.parametrize("verify", [False, True])
def test_fitting_batch_matches_reference(ref, verify):
    graphs = [_graph(ref, "g1"), _graph(ref, "g2")]
    results, flagged = ds.execute_plan_batched(
        graphs, N, 8, _plan(ref, "padded"), replan=False, verify=verify,
        device="cpu")
    _assert_batch(ref, "fit_verify" if verify else "fit", results, flagged)
    assert flagged == () and len(results) == 2
    # each request is its own strict replay
    for g, res in zip(graphs, results):
        one = ds.execute_plan(g, N, 8, _plan(ref, "padded"), replan=False)
        for a, b in zip(res[:5], one[:5]):
            assert torch.equal(a, b)


def test_stack_false_takes_stacked_tensors(ref):
    graphs = [_graph(ref, "g1"), _graph(ref, "g2")]
    stacked = DistGraph(*(torch.stack([getattr(g, k) for g in graphs])
                          for k in ("u", "v", "w", "eid")))
    results, flagged = ds.execute_plan_batched(
        stacked, N, 8, _plan(ref, "padded"), replan=False, stack=False,
        device="cpu")
    _assert_batch(ref, "fit", results, flagged)


@pytest.mark.parametrize("replan", [True, "defer"])
def test_unfit_request_is_flagged_alone(ref, replan):
    graphs = [_graph(ref, "g1"), _graph(ref, "g3")]
    results, flagged = ds.execute_plan_batched(
        graphs, N, 8, _plan(ref, "plan"), replan=replan, device="cpu")
    _assert_batch(ref, "replan" if replan is True else "defer", results,
                  flagged)
    assert flagged == (1,)
    assert (results[1] is None) == (replan == "defer")


def test_unfit_request_raises_strictly(ref):
    graphs = [_graph(ref, "g1"), _graph(ref, "g3")]
    with pytest.raises(RuntimeError) as exc:
        ds.execute_plan_batched(graphs, N, 8, _plan(ref, "plan"),
                                replan=False, device="cpu")
    assert str(exc.value) == str(ref["strict"])
    assert "batch requests [1]" in str(exc.value)


def test_batched_resume_matches_reference(ref):
    graphs = [_graph(ref, "g1"), _graph(ref, "g2")]
    padded = _plan(ref, "padded")
    cks = []
    for g in graphs:
        got = []
        ds.execute_plan(g, N, 8, padded, replan=False, ckpt_every=3,
                        ckpt_out=got)
        cks.append(got[0])
    assert {c.plan_pos for c in cks} == {int(ref["resume_pos"])}
    results, flagged = ds.execute_plan_batched(
        graphs, N, 8, padded, replan=False, resume_from=cks, device="cpu")
    _assert_batch(ref, "resumed", results, flagged)
    for res, full in zip(results, ds.execute_plan_batched(
            graphs, N, 8, padded, replan=False, device="cpu")[0]):
        assert torch.equal(res[0], full[0]) and torch.equal(res[3], full[3])
    with pytest.raises(CheckpointError, match="one checkpoint per request"):
        ds.execute_plan_batched(graphs, N, 8, padded, resume_from=cks[:1],
                                device="cpu")
    with pytest.raises(CheckpointError, match="one shared plan position"):
        ds.execute_plan_batched(
            graphs, N, 8, padded, device="cpu",
            resume_from=[cks[0], dataclasses.replace(cks[1], plan_pos=1)])
    with pytest.raises(CheckpointError, match="outside this plan"):
        ds.execute_plan_batched(
            graphs, N, 8, padded, device="cpu",
            resume_from=[dataclasses.replace(c, plan_pos=99) for c in cks])
