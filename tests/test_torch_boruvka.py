"""The port's single-device Borůvka (``engine="static"``) and graph
foundations against the JAX reference, in process: the same inputs, the
same masks, labels and layouts."""
import numpy as np
import pytest
import torch

from repro.core import graph as jax_graph
from repro.core import oracle
from repro.core.boruvka import boruvka_msf as jax_boruvka_msf
from repro.core.boruvka import min_edge_per_component as jax_min_edge
from repro_torch.core.boruvka import boruvka_msf, min_edge_per_component
from repro_torch.core import graph
from repro_torch.core.graph import (CapacityError, from_numpy,
                                    reference_order_sum)
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers.graph_families import FAMILIES

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_boruvka_msf_matches_reference(family, seed):
    u, v, w, n = FAMILIES[family](seed)
    jmask, jlab = jax_boruvka_msf(u, v, w, n)
    mask, lab = boruvka_msf(_t(u), _t(v), _t(w), n)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert lab.dtype == torch.int32
    kmask, _ = oracle.kruskal(u, v, w, n)
    np.testing.assert_array_equal(mask.numpy(), kmask)


@pytest.mark.parametrize("seed", range(4))
def test_min_edge_per_component_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, m = 50, 400
    ru = rng.integers(0, n, m).astype(np.int32)
    rv = rng.integers(0, n, m).astype(np.int32)
    w = rng.integers(1, 5, m).astype(np.float32)  # heavy ties
    w[rng.random(m) < 0.1] = np.inf  # padding slots
    jw, je = jax_min_edge(ru, rv, w, n)
    tw, te = min_edge_per_component(_t(ru), _t(rv), _t(w), n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("n", [1, 5])
def test_empty_edge_list_matches_oracle(n):
    """The reference raises on m = 0 (ROADMAP.md queue 3); the port
    returns the oracle's empty forest."""
    z = np.zeros(0, np.int32)
    zw = np.zeros(0, np.float32)
    mask, lab = boruvka_msf(_t(z), _t(z), _t(zw), n)
    kmask, _ = oracle.kruskal(z, z, zw, n)
    assert mask.shape == (0,) and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), kmask)
    np.testing.assert_array_equal(lab.numpy(), np.arange(n))
    mask, wt = minimum_spanning_forest(from_numpy(z, z, zw, n, device=CPU))
    assert mask.shape == (0,) and float(wt) == 0.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_static_api_matches_oracle(family):
    u, v, w, n = FAMILIES[family](0)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    # padded: the +inf tail must never be chosen
    mask, wt = minimum_spanning_forest(
        from_numpy(u, v, w, n, pad_to=len(u) + 7, device=CPU))
    np.testing.assert_array_equal(mask.numpy()[:len(u)], kmask)
    assert not mask.numpy()[len(u):].any()
    assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)


@pytest.mark.parametrize("shape", [(1,), (31,), (32,), (33,), (1000,),
                                   (3, 1500), (8, 40000)])
def test_reference_order_sum_matches_jax(shape):
    """The port's weights add in the reference compiler's order, so a
    float32 sum compares bit for bit."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(shape[-1])
    x = rng.uniform(1, 255, shape).astype(np.float32)
    x[rng.random(shape) < 0.5] = 0
    exp = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
    np.testing.assert_array_equal(reference_order_sum(_t(x)).numpy(), exp)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_helpers_match_reference(family):
    u, v, w, n = FAMILIES[family](0)
    # both directions plus self-loops and parallel copies
    uu = np.concatenate([u, v, u[:5]]).astype(np.int32)
    vv = np.concatenate([v, u, u[:5]]).astype(np.int32)
    ww = np.concatenate([w, w + 1, w[:5]]).astype(np.float32)
    for name in ("canonicalize_undirected", "dedup_parallel",
                 "to_directed_sorted"):
        got = getattr(graph, name)(uu, vv, ww)
        exp = getattr(jax_graph, name)(uu, vv, ww)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype, name
            np.testing.assert_array_equal(g, e, err_msg=name)
    du, dv, dw = graph.to_directed_sorted(u, v, w)
    for p in (1, 8):
        got = graph.partition_edges(du, dv, dw, n, p, device=CPU)
        exp = jax_graph.partition_edges(du, dv, dw, n, p)
        for k in ("u", "v", "w"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(exp, k)))
        assert int(got.num_valid()) == int(exp.num_valid())
    mask = np.zeros(len(u), bool)
    mask[::3] = True
    e_t = from_numpy(u, v, w, n, pad_to=len(u) + 4, device=CPU)
    e_j = jax_graph.from_numpy(u, v, w, n, pad_to=len(u) + 4)
    mk = np.concatenate([mask, np.ones(4, bool)])
    np.testing.assert_array_equal(
        graph.forest_weight(e_t, _t(mk)).numpy(),
        np.asarray(jax_graph.forest_weight(e_j, mk)))


def test_capacity_errors_are_loud():
    u, v, w, n = FAMILIES["random"](0)
    with pytest.raises(CapacityError) as err:
        from_numpy(u, v, w, n, pad_to=len(u) - 3, device=CPU)
    assert err.value.dropped == 3
    du, dv, dw = graph.to_directed_sorted(u, v, w)
    with pytest.raises(CapacityError):
        graph.partition_edges(du, dv, dw, n, 8, cap=len(du) // 8 - 1,
                              device=CPU)
