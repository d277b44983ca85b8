"""The forest verifier of the port against the JAX reference, field for
field.

One 8-device JAX subprocess (module-scoped fixture) lays out gnm n = 512
(average degree 8, seed 7) with 13 isolated vertices more, on p = 8 with
4 padding slots a shard, and builds from Kruskal's forest the slot mask
of each chosen edge's ``u < v`` copy and the labels of the component
roots.  Beside that
correct forest it breaks it four ways: a dropped mask edge, a label that
is not a fixpoint, labels out of range (one past n, one negative), and a
masked padding slot.  ``verify_forest`` runs on each with no
expectation, with the correct forest's weight and count, and with a
weight 1% off, on the ``(8,)`` mesh and for the correct forest also on a
``(4, 2)`` mesh (the two-hop grid schedule); every ``VerifyReport``,
weight included, must come out of the port on the CPU equal, and where
the reference raises ``VerifyFailure`` the port must raise it with the
same message.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import DistGraph
from repro_torch.core.verify import VerifyFailure, VerifyReport, verify_forest
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
N, EXTRA, SEED = 512, 13, 7
FORESTS = ("correct", "dropped_edge", "not_fixpoint", "out_of_range",
           "masked_padding")
EXPECT = ("none", "own", "weight_off")
CASES = ([(f, e, (8,)) for f in FORESTS for e in EXPECT]
         + [("correct", "own", (4, 2))])

REFERENCE = """
import json
from jax.sharding import Mesh
from repro.core import oracle
from repro.core.distributed import build_dist_graph
from repro.core.verify import VerifyFailure, verify_forest
from repro.data import generators

out = {}
u, v, w, n0 = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
n = n0 + EXTRA
g, cap = build_dist_graph(u, v, w, n, 8, cap=-(-2 * len(u) // 8) + 4)
gu, gv, gw, geid = (np.asarray(x) for x in g)
km, kw = oracle.kruskal(u, v, w, n)
vps = -(-n // 8)
comp = oracle.component_labels(u[km], v[km], n)
lab = np.arange(8 * vps, dtype=np.int32)
lab[:n] = comp
mask = km[geid] & (gu < gv) & np.isfinite(gw)
forests = {"correct": (mask, lab)}
m2 = mask.copy()
m2[np.flatnonzero(m2)[3]] = False
forests["dropped_edge"] = (m2, lab)
root = int(np.bincount(comp).argmax())
member = int(np.flatnonzero(comp == root)[-1])
l3 = lab.copy()
l3[root] = member
forests["not_fixpoint"] = (mask, l3)
l4 = lab.copy()
l4[5] = n
l4[n - 1] = -3
forests["out_of_range"] = (mask, l4)
m5 = mask.copy()
m5[np.flatnonzero(~np.isfinite(gw))[0]] = True
forests["masked_padding"] = (m5, lab)
own_w, own_c = float(np.sum(gw[mask], dtype=np.float32)), int(mask.sum())
expects = {"none": {}, "own": dict(expected_weight=own_w,
                                   expected_count=own_c),
           "weight_off": dict(expected_weight=own_w * 1.01)}
devs = np.array(jax.devices())
for k in ("u", "v", "w", "eid"):
    out[f"g_{k}"] = np.asarray(getattr(g, k))
out["n"] = np.asarray(n)
for name, (m, l) in forests.items():
    out[f"{name}/mask"] = m
    out[f"{name}/lab"] = l
out["expects"] = np.asarray(json.dumps(expects))
for forest, expect, layout in CASES:
    if len(layout) == 1:
        mesh = Mesh(devs, ("data",))
    else:
        mesh = Mesh(devs.reshape(layout), ("row", "col"))
    m, l = forests[forest]
    key = f"{forest}/{expect}/{'x'.join(map(str, layout))}"
    rep = verify_forest(g, n, mesh, jnp.asarray(m), jnp.asarray(l),
                        raise_on_fail=False, **expects[expect])
    out[key + "/report"] = np.asarray(json.dumps(rep._asdict()))
    try:
        verify_forest(g, n, mesh, jnp.asarray(m), jnp.asarray(l),
                      **expects[expect])
        out[key + "/raised"] = np.asarray("")
    except VerifyFailure as e:
        out[key + "/raised"] = np.asarray(str(e))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference_verify") / "ref.npz"
    body = (f"OUT = {str(path)!r}\nN = {N}\nEXTRA = {EXTRA}\n"
            f"SEED = {SEED}\nCASES = {CASES!r}\n" + REFERENCE)
    assert "OK" in run_reference(body, ndev=8, timeout=600)
    with np.load(path) as data:
        return dict(data)


def _case_key(forest, expect, layout):
    return f"{forest}/{expect}/{'x'.join(map(str, layout))}"


@pytest.mark.parametrize("forest,expect,layout", CASES,
                         ids=[_case_key(*c) for c in CASES])
def test_report_matches_reference(ref, forest, expect, layout):
    g = DistGraph.from_numpy(*(ref[f"g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    n = int(ref["n"])
    mask = torch.from_numpy(ref[f"{forest}/mask"])
    lab = torch.from_numpy(ref[f"{forest}/lab"])
    kw = json.loads(str(ref["expects"]))[expect]
    shards = layout if len(layout) > 1 else layout[0]
    key = _case_key(forest, expect, layout)
    rep = verify_forest(g, n, shards, mask, lab, raise_on_fail=False,
                        device=CPU, **kw)
    exp = json.loads(str(ref[key + "/report"]))
    exp["reasons"] = tuple(exp["reasons"])
    assert rep == VerifyReport(**exp)
    assert isinstance(rep.weight, float) and isinstance(rep.count, int)
    assert rep.ok == (forest == "correct" and expect != "weight_off")
    raised = str(ref[key + "/raised"])
    if raised:
        with pytest.raises(VerifyFailure) as exc:
            verify_forest(g, n, shards, mask, lab, device=CPU, **kw)
        assert str(exc.value) == raised
        assert exc.value.report == rep
    else:
        assert verify_forest(g, n, shards, mask, lab, device=CPU,
                             **kw) == rep
