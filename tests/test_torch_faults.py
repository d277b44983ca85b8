"""Fault injection in the port against the JAX reference, bit for bit.

In process, ``repro_torch.comm.faults`` is held to ``repro.comm.faults``:
the same plans rejected with the same messages, the same site hashes and
site matching, and the ``inject`` lifecycle (not reentrant, cleared on
exit).

One 8-device JAX subprocess (module-scoped fixture) computes the
reference's ``_select`` masks inside ``shard_map`` on ``(8,)`` and
``(4, 2)`` meshes, and on gnm n = 256 (average degree 8, seed 7, p = 8)
the strict replay of a plan (``pallas_minedges=False``: its kernel path
does not run under this JAX, ROADMAP.md queue 3) under one spec of each
fault kind at its ``FAULT_MATRIX`` site, two ``abort`` specs, and one
``GRID_FAULT_MATRIX`` cell on a ``(4, 2)`` mesh.  The plans are the
port's, whose JSON equals the reference's own measurement byte for byte
(tests/test_torch_plan.py), so the subprocess spends no measurement
pass.  The port replays them under the same specs with
``pallas_minedges=True`` (K1's plain version on the CPU): the mask,
labels, weight, count, overflow, residual and every ``CommStats`` field,
``injected`` included, must be equal, and a strict ``execute_plan`` must
return where the reference's returns and raise the same error type where
it raises.
"""
import numpy as np
import pytest
import torch

import repro.comm.faults as jax_faults
from repro_torch.comm import faults
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import build_dist_graph
from repro_torch.core.plan import RoundPlan
from repro_torch.data import generators
from repro_torch.launch.chaos import FAULT_MATRIX, GRID_FAULT_MATRIX
from tests.helpers.subproc import run_multidevice

CPU = torch.device("cpu")
N, SEED = 256, 7
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")

# (seed, site, salt, per-shard shape, fraction, layout)
SELECT_CASES = [
    (0, "minedges", 0, (37,), 0.25, (8,)),
    (7, "push", 101, (8, 5), 0.5, (8,)),
    (123456789, "", 3, (3, 4, 2), 1.0, (8,)),
    (5, "ghost_push_row", 1, (64,), 0.0, (8,)),
    (2 ** 31 + 11, "contract", 102, (6, 7), 0.3333, (4, 2)),
    (1, "ghost_push_col", 0, (2, 33), 0.75, (4, 2)),
]


def _spec_dict(spec):
    return {k: getattr(spec, k) for k in spec._fields}


# (cell name, layout, spec as a dict of FaultSpec fields)
CELLS = ([(name, (8,), _spec_dict(spec)) for name, spec in FAULT_MATRIX]
         + [("abort_any_round", (8,), dict(kind="abort", site="minedges")),
            ("abort_round_1", (8,), dict(kind="abort", site="minedges",
                                         rounds=(1,))),
            ("grid_drop_col", (4, 2), _spec_dict(GRID_FAULT_MATRIX[0][1]))])

REFERENCE = """
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import faults
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import (_build_planned_fn,
                                            execute_plan,
                                            vertices_per_shard)
from repro.core.plan import RoundPlan
from repro.data import generators

out = {}
devs = np.array(jax.devices())


def mesh_of(layout):
    if len(layout) == 1:
        return Mesh(devs, ("data",)), ("data",)
    return Mesh(devs.reshape(layout), ("row", "col")), ("row", "col")


for layout in sorted({c[-1] for c in SELECT_CASES}):
    mesh, ax = mesh_of(layout)
    cases = [(i, c) for i, c in enumerate(SELECT_CASES) if c[-1] == layout]

    def f(x, cases=cases, ax=ax):
        return tuple(faults._select(seed, site, salt, tuple(shape),
                                    fraction, ax)[None]
                     for _, (seed, site, salt, shape, fraction, _) in cases)

    sels = shard_map(f, mesh=mesh, in_specs=P(ax),
                     out_specs=tuple(P(ax) for _ in cases))(jnp.zeros(8))
    for (i, _), sel in zip(cases, sels):
        out[f"select/{i}"] = np.asarray(sel)

u, v, w, n = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
g = build_dist_graph(u, v, w, n, 8)[0]
vps = vertices_per_shard(n, 8)
plans = {layout: RoundPlan.from_json(text)
         for layout, text in PLANS.items()}
for name, layout, spec in CELLS:
    mesh, ax = mesh_of(layout)
    plan = plans[layout]
    fp = faults.FaultPlan(seed=SEED, specs=(faults.FaultSpec(**spec),))
    with faults.inject(fp):
        try:
            res = _build_planned_fn(n, vps, mesh, ax, plan)(
                g.u, g.v, g.w, g.eid)
        except faults.ShardAbort as e:
            out[f"{name}/abort"] = np.asarray([e.site, str(e.round),
                                               str(e.shard)])
        else:
            for nm, x in zip(("mask", "weight", "count", "labels",
                              "overflow", "residual"), res[:6]):
                out[f"{name}/{nm}"] = np.asarray(x)
            for fld in STATS:
                out[f"{name}/stat_{fld}"] = np.asarray(getattr(res[6], fld))
        # the same program again (memoized inside this block)
        try:
            execute_plan(g, n, mesh, plan, axis_names=ax, replan=False)
            out[f"{name}/strict"] = np.asarray("returned")
        except Exception as e:
            out[f"{name}/strict"] = np.asarray(type(e).__name__)
np.savez(OUT, **out)
print("OK")
"""


def _graph():
    u, v, w, n = generators.generate("gnm", N, avg_degree=8.0, seed=SEED)
    return build_dist_graph(u, v, w, n, 8, device=CPU)[0]


@pytest.fixture(scope="module")
def plans():
    """The port's plans of the graph on both layouts, measured with
    ``pallas_minedges=False``: their JSON is the reference's byte for
    byte (tests/test_torch_plan.py), so the reference replays them
    without a measurement pass of its own."""
    g = _graph()
    return {layout: ds.plan_sharded_msf(
        g, N, layout if len(layout) > 1 else layout[0],
        pallas_minedges=False,
        **(dict(ghost_push="grid") if len(layout) > 1 else {})).to_json()
        for layout in sorted({c[1] for c in CELLS})}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, plans):
    path = tmp_path_factory.mktemp("jax_reference_faults") / "ref.npz"
    body = (f"OUT = {str(path)!r}\nN = {N}\nSEED = {SEED}\n"
            f"SELECT_CASES = {SELECT_CASES!r}\nCELLS = {CELLS!r}\n"
            f"STATS = {STATS!r}\nPLANS = {plans!r}\n" + REFERENCE)
    assert "OK" in run_multidevice(body, ndev=8, timeout=900)
    with np.load(path) as data:
        return dict(data)


def _plan(plans, layout):
    return RoundPlan.from_json(plans[layout])._replace(pallas_minedges=True)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

BAD_SPECS = [dict(kind="melt"), dict(kind="drop", site="minedgez"),
             dict(kind="drop", fraction=1.5), dict(kind="clip", cap_frac=0.0),
             dict(kind="corrupt", bit=32), dict(kind="abort", rounds=(0,)),
             dict(kind="abort", rounds=(1.0,))]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_plan_validation_matches_reference(bad):
    with pytest.raises(ValueError) as jexc:
        jax_faults.FaultPlan(specs=(jax_faults.FaultSpec(**bad),)).validate()
    with pytest.raises(ValueError) as texc:
        faults.FaultPlan(specs=(faults.FaultSpec(**bad),)).validate()
    assert str(texc.value) == str(jexc.value)
    with pytest.raises(ValueError):
        with faults.inject(faults.FaultPlan(specs=(
                faults.FaultSpec(**bad),))):
            pass
    assert faults.active() is None


def test_sites_hashes_and_matching_match_reference():
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS
    for site in faults.KNOWN_SITES + ("a" * 40,):
        assert faults._site_hash(site) == jax_faults._site_hash(site)
        for target in ("", "minedges", "verify"):
            assert (faults.FaultSpec("drop", site=target).matches(site)
                    == jax_faults.FaultSpec("drop", site=target)
                    .matches(site))


def test_inject_lifecycle():
    plan = faults.FaultPlan(seed=3, specs=(
        faults.FaultSpec("drop", site="push"),
        faults.FaultSpec("stall", site="minedges", shard=2)))
    assert faults.active() is None and faults.specs_for("push") == ()
    with faults.inject(plan) as active:
        assert active is plan and faults.active() is plan
        assert faults.current_round() == 0
        faults.set_round(4)
        assert faults.current_round() == 4
        assert faults.specs_for("push") == (plan.specs[0],)
        assert faults.specs_for("verify") == ()
        with pytest.raises(RuntimeError, match="not reentrant"):
            with faults.inject(plan):
                pass
        assert faults.active() is plan
    assert faults.active() is None and faults.specs_for("push") == ()
    with pytest.raises(KeyError):
        with faults.inject(plan):
            raise KeyError("inside")
    assert faults.active() is None
    with faults.inject(plan):
        assert faults.current_round() == 0  # reset on entry


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SELECT_CASES)))
def test_select_matches_reference(ref, i):
    seed, site, salt, shape, fraction, _ = SELECT_CASES[i]
    got = faults._select(seed, site, salt, (8,) + shape, fraction, CPU)
    exp = ref[f"select/{i}"]
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got.numpy(), exp)
    if 0 < fraction < 1:
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("name,layout,spec", CELLS,
                         ids=[c[0] for c in CELLS])
def test_faulted_replay_matches_reference(ref, plans, name, layout, spec):
    g = _graph()
    plan = _plan(plans, layout)
    shards = layout if len(layout) > 1 else layout[0]
    fp = faults.FaultPlan(seed=SEED, specs=(faults.FaultSpec(**spec),))
    if f"{name}/abort" in ref:
        with pytest.raises(faults.ShardAbort) as exc:
            with faults.inject(fp):
                ds._run_plan(g, N, layout, plan)
        assert [exc.value.site, str(exc.value.round),
                str(exc.value.shard)] == list(ref[f"{name}/abort"])
    else:
        with faults.inject(fp):
            res = ds._run_plan(g, N, layout, plan)
        got = dict(zip(("mask", "weight", "count", "labels", "overflow",
                        "residual"), res[:6]))
        got.update({"stat_" + f: getattr(res[6], f) for f in STATS})
        for key, x in got.items():
            exp = ref[f"{name}/{key}"]
            x = x.numpy()
            assert x.dtype == exp.dtype, (name, key)
            np.testing.assert_array_equal(x, exp, err_msg=f"{name} {key}")
        assert float(res[6].injected) > 0 or spec["kind"] == "abort"
    with faults.inject(fp):
        try:
            ds.execute_plan(g, N, shards, plan, replan=False)
            strict = "returned"
        except Exception as e:  # the type is what is compared
            strict = type(e).__name__
    assert strict == str(ref[f"{name}/strict"])
    assert faults.active() is None


def test_no_active_plan_is_bit_identical(plans):
    """Replays before any injection, after faulted ones, and inside an
    empty plan are equal on every output and counter."""
    g = _graph()
    plan = _plan(plans, (8,))
    before = ds._run_plan(g, N, (8,), plan)
    for _, spec in FAULT_MATRIX:
        with faults.inject(faults.FaultPlan(seed=SEED, specs=(spec,))):
            ds._run_plan(g, N, (8,), plan)
    after = ds._run_plan(g, N, (8,), plan)
    with faults.inject(faults.FaultPlan(seed=SEED)):
        empty = ds._run_plan(g, N, (8,), plan)
    with faults.inject(faults.FaultPlan(seed=SEED, specs=(
            faults.FaultSpec("drop", site="verify"),))):
        other_site = ds._run_plan(g, N, (8,), plan)
    for res in (after, empty, other_site):
        for a, b in zip(before[:6], res[:6]):
            assert torch.equal(a, b)
        for a, b in zip(before[6], res[6]):
            assert torch.equal(a, b)
    assert float(before[6].injected) == 0.0
    assert int(before[4]) == 0 and int(before[5]) == 0
