"""The port's Filter-Borůvka engines (static and dynamic), the dynamic
Borůvka and the single-device dispatch of ``minimum_spanning_forest``
against the JAX reference, in process: the same numpy inputs, the same
masks, labels and weights, and the Kruskal edge set.  Also the static
``boruvka_round``, round by round."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter_boruvka as jax_fb
from repro.core import oracle
from repro.core.boruvka import boruvka_round as jax_boruvka_round
from repro_torch.core import filter_boruvka as fb
from repro_torch.core.boruvka import boruvka_round
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers.graph_families import FAMILIES

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
SEEDS = [0, 1, 2]
# low enough that the recursion splits every family before its base case
MIN_EDGES = 64


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_static_filter_boruvka_matches_reference(family, seed):
    u, v, w, n = FAMILIES[family](seed)
    jmask, jlab = jax_fb.filter_boruvka_msf(u, v, w, n)
    mask, lab = fb.filter_boruvka_msf(_t(u), _t(v), _t(w), n)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert lab.dtype == torch.int32 and mask.dtype == torch.bool
    kmask, _ = oracle.kruskal(u, v, w, n)
    np.testing.assert_array_equal(mask.numpy(), kmask)


@pytest.mark.parametrize("num_buckets", [1, 3, 50])
def test_static_filter_boruvka_buckets_match_reference(num_buckets):
    u, v, w, n = FAMILIES["dup_weights"](0)
    jmask, jlab = jax_fb.filter_boruvka_msf(u, v, w, n,
                                            num_buckets=num_buckets)
    mask, lab = fb.filter_boruvka_msf(_t(u), _t(v), _t(w), n,
                                      num_buckets=num_buckets)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


def test_static_filter_boruvka_signed_zeros_and_ties():
    """The bucket sort orders as the reference's stable float sort: -0.0
    ties +0.0, and equal weights go by edge index."""
    rng = np.random.default_rng(5)
    n, m = 40, 300
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0], np.float32), m)
    for buckets in (1, 4, 8):
        jmask, jlab = jax_fb.filter_boruvka_msf(u, v, w, n,
                                                num_buckets=buckets)
        mask, lab = fb.filter_boruvka_msf(_t(u), _t(v), _t(w), n,
                                          num_buckets=buckets)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dynamic_engines_match_reference(family, seed):
    u, v, w, n = FAMILIES[family](seed)
    kmask, _ = oracle.kruskal(u, v, w, n)
    jmask, jwt = jax_fb.filter_boruvka_dynamic(u, v, w, n,
                                               min_edges=MIN_EDGES,
                                               seed=seed)
    mask, wt = fb.filter_boruvka_dynamic(u, v, w, n, min_edges=MIN_EDGES,
                                         seed=seed, device="cpu")
    np.testing.assert_array_equal(mask, jmask)
    assert wt == jwt
    np.testing.assert_array_equal(mask, kmask)
    jmask, jwt = jax_fb.boruvka_dynamic(u, v, w, n)
    mask, wt = fb.boruvka_dynamic(u, v, w, n, device="cpu")
    np.testing.assert_array_equal(mask, jmask)
    assert wt == jwt
    np.testing.assert_array_equal(mask, kmask)


def test_dynamic_recursion_splits():
    """At MIN_EDGES the recursion takes a pivot before its base cases
    (more than one base case runs), so the pivot draws are exercised."""
    u, v, w, n = FAMILIES["random"](0)
    calls = []
    real = fb._padded_base_case

    def spy(eu, *args):
        calls.append(len(eu))
        return real(eu, *args)

    fb._padded_base_case = spy
    try:
        fb.filter_boruvka_dynamic(u, v, w, n, min_edges=MIN_EDGES,
                                  device="cpu")
    finally:
        fb._padded_base_case = real
    assert len(calls) >= 2 and max(calls) < len(u)


@pytest.mark.parametrize("n", [1, 5])
def test_empty_graph_matches_oracle(n):
    """m = 0: the reference's static engine raises (ROADMAP.md queue 3);
    every port engine returns the oracle's empty forest."""
    z = np.zeros(0, np.int32)
    zw = np.zeros(0, np.float32)
    kmask, kweight = oracle.kruskal(z, z, zw, n)
    mask, lab = fb.filter_boruvka_msf(_t(z), _t(z), _t(zw), n)
    assert mask.shape == (0,) and mask.dtype == torch.bool
    np.testing.assert_array_equal(lab.numpy(), np.arange(n))
    for run in (fb.filter_boruvka_dynamic, fb.boruvka_dynamic):
        mask, wt = run(z, z, zw, n, device="cpu")
        np.testing.assert_array_equal(mask, kmask)
        assert wt == kweight == 0.0
    edges = from_numpy(z, z, zw, n, device=CPU)
    for engine in ("static", "dynamic"):
        mask, wt = minimum_spanning_forest(edges, engine=engine,
                                           algorithm="filter_boruvka")
        assert mask.shape == (0,) and float(wt) == 0.0


@pytest.mark.parametrize("algorithm", ["boruvka", "filter_boruvka"])
@pytest.mark.parametrize("engine", ["static", "dynamic"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_public_api_matches_oracle(family, engine, algorithm):
    u, v, w, n = FAMILIES[family](0)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    # padded: the +inf tail must never be chosen
    edges = from_numpy(u, v, w, n, pad_to=len(u) + 7, device=CPU)
    mask, wt = minimum_spanning_forest(edges, engine=engine,
                                       algorithm=algorithm)
    assert mask.device.type == "cpu" and wt.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy()[:len(u)], kmask)
    assert not mask.numpy()[len(u):].any()
    assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)
    assert fb.validate_against_oracle(u, v, w, n, mask.numpy()[:len(u)])


def test_public_api_knobs():
    u, v, w, n = FAMILIES["clustered"](1)
    kmask, _ = oracle.kruskal(u, v, w, n)
    edges = from_numpy(u, v, w, n, device=CPU)
    mask, _ = minimum_spanning_forest(edges, algorithm="filter_boruvka",
                                      num_buckets=3)
    np.testing.assert_array_equal(mask.numpy(), kmask)
    mask, _ = minimum_spanning_forest(edges, engine="dynamic",
                                      algorithm="filter_boruvka",
                                      min_edges=32, sample_size=16, seed=4)
    np.testing.assert_array_equal(mask.numpy(), kmask)
    with pytest.raises(ValueError):
        minimum_spanning_forest(edges, engine="dynamic", algorithm="prim")
    with pytest.raises(ValueError):
        minimum_spanning_forest(edges, num_buckets=0)


@pytest.mark.parametrize("family", ["random", "clustered", "selfloops"])
def test_boruvka_rounds_match_reference(family):
    """Labels, mask and the changed flag of the static Borůvka round equal
    JAX's in every round, to the round where nothing changes."""
    u, v, w, n = FAMILIES[family](0)
    ju, jv, jw = jnp.asarray(u), jnp.asarray(v), jnp.asarray(w)
    jlab = jnp.arange(n, dtype=jnp.int32)
    jmst = jnp.zeros(len(u), bool)
    tu, tv, tw = _t(u), _t(v), _t(w)
    lab = torch.arange(n, dtype=torch.int32)
    mst = torch.zeros(len(u), dtype=torch.bool)
    rounds = 0
    changed = True
    while changed:
        jlab, jmst, jch = jax_boruvka_round(ju, jv, jw, jlab, jmst, n)
        lab, mst, ch = boruvka_round(tu, tv, tw, lab, mst, n)
        rounds += 1
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab),
                                      err_msg=f"round {rounds} labels")
        np.testing.assert_array_equal(mst.numpy(), np.asarray(jmst),
                                      err_msg=f"round {rounds} mask")
        assert bool(ch) == bool(jch), rounds
        changed = bool(ch)
    assert rounds >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["boruvka", "filter_boruvka"])
@pytest.mark.parametrize("engine", ["static", "dynamic"])
def test_cuda_engines_match_oracle(engine, algorithm):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    u, v, w, n = FAMILIES["dup_weights"](0)
    kmask, _ = oracle.kruskal(u, v, w, n)
    mask, _ = minimum_spanning_forest(from_numpy(u, v, w, n),
                                      engine=engine, algorithm=algorithm)
    assert mask.device.type == "cuda"
    np.testing.assert_array_equal(mask.cpu().numpy(), kmask)
