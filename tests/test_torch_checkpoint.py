"""Round checkpoints of the port against the JAX reference, field for
field and CRC for CRC.

One 8-device JAX subprocess (module-scoped fixture) runs, on gnm n = 512
(average degree 8, seed 7), with ``pallas_minedges=False`` (its kernel
path does not run under this JAX, ROADMAP.md queue 3):

  * the driven engine with ``ckpt_every=2`` for both algorithms, and the
    resume from one of its checkpoints;
  * a measured plan's strict replay with ``ckpt_every=3``, and the
    resume from its first checkpoint;
  * the remap of the last boruvka checkpoint onto p = 4 (the graph laid
    out again at 4 shards), and the driven resume from it.

The port (``pallas_minedges=True``, K1's plain version on the CPU) must
take the same checkpoints — every field, ``checksums`` included — and
return the same results (mask, weight, count, labels, overflow, every
``CommStats`` field).  Each reference checkpoint, carried over as numpy
arrays, must resume in the port to the reference's resumed result, as
must the port's own (equal) checkpoint; the remapped resume must also be
Kruskal's edge set.  The ``CheckpointError`` cases are the port's own.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core.msf_checkpoint as jax_ckpt
from repro.core import oracle
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import DistGraph
from repro_torch.core.msf_checkpoint import (CheckpointError, MSFCheckpoint,
                                             latest_certified)
from repro_torch.core.plan import RoundPlan
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
N, SEED = 512, 7
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")
FIELDS = tuple(f.name for f in dataclasses.fields(MSFCheckpoint))
RESULT = ("mask", "weight", "count", "labels", "overflow")
ALGOS = ("boruvka", "filter_boruvka")

REFERENCE = """
import dataclasses
import json
from jax.sharding import Mesh
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import (distributed_sharded_msf,
                                            execute_plan, plan_sharded_msf)
from repro.data import generators

out = {}
devs = np.array(jax.devices())
mesh = Mesh(devs, ("data",))
u, v, w, n = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
for k, x in (("u", u), ("v", v), ("w", w)):
    out[f"raw_{k}"] = np.asarray(x)
g = build_dist_graph(u, v, w, n, 8)[0]
for k in ("u", "v", "w", "eid"):
    out[f"g_{k}"] = np.asarray(getattr(g, k))


def save_ck(prefix, ck):
    for f in dataclasses.fields(ck):
        x = getattr(ck, f.name)
        if f.name == "level_bounds":
            x = json.dumps([[repr(a), repr(b)] for a, b in x])
        elif f.name == "plan_pos" and x is None:
            x = -1
        out[f"{prefix}/{f.name}"] = np.asarray(x)


def save_res(prefix, res):
    for nm, x in zip(RESULT, res[:5]):
        out[f"{prefix}/{nm}"] = np.asarray(x)
    for f in STATS:
        out[f"{prefix}/stat_{f}"] = np.asarray(getattr(res[5], f))


for algo in ALGOS:
    cks = []
    res = distributed_sharded_msf(g, n, mesh, algorithm=algo,
                                  pallas_minedges=False, ckpt_every=2,
                                  ckpt_out=cks)
    save_res(f"driver/{algo}", res)
    out[f"driver/{algo}/num_ckpts"] = np.asarray(len(cks))
    for i, ck in enumerate(cks):
        save_ck(f"driver/{algo}/ck{i}", ck)
    pick = len(cks) // 2
    out[f"driver/{algo}/resume_pick"] = np.asarray(pick)
    save_res(f"driver/{algo}/resumed",
             distributed_sharded_msf(g, n, mesh, algorithm=algo,
                                     pallas_minedges=False,
                                     resume_from=cks[pick]))
    if algo == "boruvka":
        last = cks[-1]

plan = plan_sharded_msf(g, n, mesh, pallas_minedges=False)
out["plan"] = np.asarray(plan.to_json())
pcks = []
save_res("planned", execute_plan(g, n, mesh, plan, replan=False,
                                 ckpt_every=3, ckpt_out=pcks))
out["planned/num_ckpts"] = np.asarray(len(pcks))
for i, ck in enumerate(pcks):
    save_ck(f"planned/ck{i}", ck)
save_res("planned/resumed", execute_plan(g, n, mesh, plan, replan=False,
                                         resume_from=pcks[0]))

g4, cap4 = build_dist_graph(u, v, w, n, 4)
for k in ("u", "v", "w", "eid"):
    out[f"g4_{k}"] = np.asarray(getattr(g4, k))
ck4 = last.remap(4, cap4, np.asarray(g4.u), np.asarray(g4.v),
                 np.asarray(g4.eid))
save_ck("remap/ck", ck4)
save_res("remap/resumed", distributed_sharded_msf(
    g4, n, Mesh(devs[:4], ("data",)), pallas_minedges=False,
    resume_from=ck4))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference_ckpt") / "ref.npz"
    body = (f"OUT = {str(path)!r}\nN = {N}\nSEED = {SEED}\n"
            f"STATS = {STATS!r}\nRESULT = {RESULT!r}\nALGOS = {ALGOS!r}\n"
            + REFERENCE)
    assert "OK" in run_reference(body, ndev=8, timeout=900)
    with np.load(path) as data:
        return dict(data)


def _graph(ref, prefix="g"):
    return DistGraph.from_numpy(*(ref[f"{prefix}_{k}"]
                                  for k in ("u", "v", "w", "eid")),
                                device=CPU)


def _ref_ck(ref, prefix) -> MSFCheckpoint:
    """A reference checkpoint, carried over as numpy arrays."""
    kw = {}
    for f in FIELDS:
        x = ref[f"{prefix}/{f}"]
        if f == "level_bounds":
            x = tuple((float(a), float(b)) for a, b in json.loads(str(x)))
        elif f == "plan_pos":
            x = None if int(x) < 0 else int(x)
        elif f in ("n", "num_shards", "cap_per_shard", "round_index",
                   "level", "round_in_level"):
            x = int(x)
        elif f == "algorithm":
            x = str(x)
        elif f == "ghost_on":
            x = bool(x)
        kw[f] = x
    return MSFCheckpoint(**kw)


def _assert_ck(got: MSFCheckpoint, exp: MSFCheckpoint, what):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(exp, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, (what, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
        else:
            assert a == b, (what, f, a, b)
    got.verify_checksums()


def _assert_res(ref, prefix, res):
    for nm, x in zip(RESULT, res[:5]):
        exp = ref[f"{prefix}/{nm}"]
        x = x.cpu().numpy()
        assert x.dtype == exp.dtype, (prefix, nm)
        np.testing.assert_array_equal(x, exp, err_msg=f"{prefix} {nm}")
    for f in STATS:
        np.testing.assert_array_equal(getattr(res[5], f).numpy(),
                                      ref[f"{prefix}/stat_{f}"],
                                      err_msg=f"{prefix} {f}")


def _plan(ref):
    return RoundPlan.from_json(str(ref["plan"]))._replace(
        pallas_minedges=True)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_driver_checkpoints_match_reference(ref, algorithm):
    g = _graph(ref)
    cks = []
    res = ds.distributed_sharded_msf(g, N, 8, algorithm=algorithm,
                                     pallas_minedges=True, ckpt_every=2,
                                     ckpt_out=cks)
    prefix = f"driver/{algorithm}"
    _assert_res(ref, prefix, res)
    assert len(cks) == int(ref[prefix + "/num_ckpts"]) > 0
    for i, ck in enumerate(cks):
        _assert_ck(ck, _ref_ck(ref, f"{prefix}/ck{i}"), f"{prefix} ck{i}")
        assert ck.plan_pos is None and ck.round_index == 2 * (i + 1)
    assert latest_certified(cks) is cks[-1] and latest_certified([]) is None


@pytest.mark.parametrize("carried", ["reference", "port"])
@pytest.mark.parametrize("algorithm", ALGOS)
def test_driver_resume_matches_reference(ref, algorithm, carried):
    """The reference's checkpoint and the port's own, which is equal to
    it, both resume in the port to the reference's resumed result, and
    the resumed forest is the uninterrupted one."""
    g = _graph(ref)
    prefix = f"driver/{algorithm}"
    pick = int(ref[prefix + "/resume_pick"])
    if carried == "reference":
        ck = _ref_ck(ref, f"{prefix}/ck{pick}")
    else:
        cks = []
        ds.distributed_sharded_msf(g, N, 8, algorithm=algorithm,
                                   pallas_minedges=True, ckpt_every=2,
                                   ckpt_out=cks)
        ck = cks[pick]
    res = ds.distributed_sharded_msf(g, N, 8, algorithm=algorithm,
                                     pallas_minedges=True, resume_from=ck)
    _assert_res(ref, prefix + "/resumed", res)
    np.testing.assert_array_equal(res[0].numpy(), ref[prefix + "/mask"])
    np.testing.assert_array_equal(res[3].numpy(), ref[prefix + "/labels"])


def test_planned_checkpoints_and_resume_match_reference(ref):
    g = _graph(ref)
    plan = _plan(ref)
    pcks = []
    res = ds.execute_plan(g, N, 8, plan, replan=False, ckpt_every=3,
                          ckpt_out=pcks)
    _assert_res(ref, "planned", res)
    assert len(pcks) == int(ref["planned/num_ckpts"]) > 0
    for i, ck in enumerate(pcks):
        _assert_ck(ck, _ref_ck(ref, f"planned/ck{i}"), f"planned ck{i}")
        assert ck.plan_pos == 3 * (i + 1)
    plain = ds.execute_plan(g, N, 8, plan, replan=False)
    for a, b in zip(res[:5], plain[:5]):
        assert torch.equal(a, b)
    for ck in (_ref_ck(ref, "planned/ck0"), pcks[0]):
        res = ds.execute_plan(g, N, 8, plan, replan=False, resume_from=ck)
        _assert_res(ref, "planned/resumed", res)
    # a checkpoint at the plan's end resumes to its own forest
    end = dataclasses.replace(pcks[-1], plan_pos=plan.num_rounds)
    res = ds.execute_plan(g, N, 8, plan, replan=False, resume_from=end)
    assert torch.equal(res[0], torch.from_numpy(end.mask))
    assert int(res[2]) == end.mst_count


def test_remap_and_elastic_resume_match_reference(ref):
    g4 = _graph(ref, "g4")
    last = _ref_ck(ref, "driver/boruvka/ck"
                   f"{int(ref['driver/boruvka/num_ckpts']) - 1}")
    ck4 = last.remap(4, g4.cap_total // 4, g4.u.numpy(), g4.v.numpy(),
                     g4.eid.numpy())
    _assert_ck(ck4, _ref_ck(ref, "remap/ck"), "remap")
    # the reference's module remaps the same checkpoint to the same bytes
    jck = jax_ckpt.MSFCheckpoint(**{f: getattr(last, f) for f in FIELDS})
    jck4 = jck.remap(4, g4.cap_total // 4, g4.u.numpy(), g4.v.numpy(),
                     g4.eid.numpy())
    np.testing.assert_array_equal(jck4.checksums, ck4.checksums)
    res = ds.distributed_sharded_msf(g4, N, 4, pallas_minedges=True,
                                     resume_from=ck4)
    _assert_res(ref, "remap/resumed", res)
    kmask, _ = oracle.kruskal(ref["raw_u"], ref["raw_v"], ref["raw_w"], N)
    sel = np.unique(g4.eid.numpy()[res[0].numpy()])
    np.testing.assert_array_equal(sel, np.flatnonzero(kmask))


def test_checkpoint_errors(ref):
    g = _graph(ref)
    plan = _plan(ref)
    driver_ck = _ref_ck(ref, "driver/boruvka/ck0")
    planned_ck = _ref_ck(ref, "planned/ck0")
    lab = driver_ck.lab.copy()
    lab[7] ^= 1
    bad_crc = dataclasses.replace(driver_ck, lab=lab)
    with pytest.raises(CheckpointError, match=r"shard\(s\) \[0\]"):
        bad_crc.verify_checksums()
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        ds.distributed_sharded_msf(g, N, 8, resume_from=bad_crc)
    with pytest.raises(CheckpointError, match="use remap"):
        driver_ck.validate_for(N, 4, g.cap_total // 4)
    with pytest.raises(CheckpointError, match="use remap"):
        ds.distributed_sharded_msf(g, N + 1, 8, resume_from=driver_ck)
    with pytest.raises(CheckpointError, match="algorithm 'boruvka'"):
        ds.distributed_sharded_msf(g, N, 8, algorithm="filter_boruvka",
                                   resume_from=driver_ck)
    far = dataclasses.replace(planned_ck, plan_pos=plan.num_rounds + 2)
    with pytest.raises(CheckpointError, match="outside this plan"):
        ds.execute_plan(g, N, 8, plan, resume_from=far)
    with pytest.raises(CheckpointError, match="taken by the host driver"):
        ds.execute_plan(g, N, 8, plan, resume_from=driver_ck)
    with pytest.raises(CheckpointError, match="re-partitioned"):
        driver_ck.remap(4, 3, g.u.numpy(), g.v.numpy(), g.eid.numpy())
    # the same messages as the reference's module on the same values
    jbad = jax_ckpt.MSFCheckpoint(**{f: getattr(bad_crc, f) for f in FIELDS})
    with pytest.raises(jax_ckpt.CheckpointError) as jexc:
        jbad.verify_checksums()
    with pytest.raises(CheckpointError) as texc:
        bad_crc.verify_checksums()
    assert str(texc.value) == str(jexc.value)
    assert repr(driver_ck) == repr(jax_ckpt.MSFCheckpoint(
        **{f: getattr(driver_ck, f) for f in FIELDS}))
