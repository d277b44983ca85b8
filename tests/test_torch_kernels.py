"""K2 (the fused relabel) and K3 (the block-segmented run-end min) in the
port, through ``relabel_edges`` and ``min_edges_dense``, against the JAX
reference in process: its ``ref.py`` oracles and its Pallas kernels in
interpret mode, on the same numpy inputs.  Exact equality throughout
(``-0.0 == +0.0``).

K3's output depends on ``block``: the port's blocked plain version (what
the K3 wrapper runs on CPU tensors) is held to the Pallas candidates at
equal ``block`` where ``seg`` is sorted, the reference's documented input.
On unsorted ``seg`` the Pallas kernel can fold an earlier run of the same
value into a later one; the port keeps runs contiguous, and the dense
result of ``min_edges_dense`` is the same either way.

The CUDA kernels run only on the card: ``test_cuda_*`` hold them against
the plain versions there and skip without a GPU (``python3 chip_smoke.py``
runs the same comparisons on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.relabel.ref import relabel_ref as jax_relabel_ref
from repro.kernels.relabel.relabel import relabel as jax_relabel
from repro.kernels.segmin.ops import min_edges_dense as jax_min_edges_dense
from repro.kernels.segmin.ref import segmin_candidates_ref as jax_seg_ref
from repro.kernels.segmin.segmin import segmin_candidates as jax_segmin
from repro_torch.core.boruvka import min_edge_per_component
from repro_torch.kernels.relabel.ops import relabel_edges
from repro_torch.kernels.relabel.ref import relabel_ref
from repro_torch.kernels.relabel.relabel import relabel
from repro_torch.kernels.segmin.ops import min_edges_dense
from repro_torch.kernels.segmin.ref import (EID_SENTINEL,
                                            segmin_candidates_ref)
from repro_torch.kernels.segmin.segmin import segmin_candidates
from tests.helpers.graph_families import FAMILIES
from tests.test_kernels import _sorted_run_problem

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _assert_equal(got, exp, ctx):
    for k, (g, e) in enumerate(zip(got, exp)):
        g = np.asarray(g)
        e = np.asarray(e)
        assert g.dtype == e.dtype, (ctx, k, g.dtype, e.dtype)
        np.testing.assert_array_equal(g, e, err_msg=f"{ctx}: output {k}")


# ---------------------------------------------------------------------------
# K2: relabel
# ---------------------------------------------------------------------------

def _relabel_problem(m, n, seed):
    """The inputs of tests/test_kernels.py: test_relabel_matches_ref."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = np.where(rng.random(m) < 0.1, np.inf,
                 rng.uniform(1, 255, m)).astype(np.float32)
    lab = rng.integers(0, n, n).astype(np.int32)
    lab = np.minimum(lab, np.arange(n, dtype=np.int32))
    for _ in range(20):
        lab = lab[lab]
    return u, v, w, lab


def _check_relabel(u, v, w, lab, block, ctx):
    """Both port paths == JAX oracle == JAX Pallas kernel."""
    exp_ref = jax_relabel_ref(*(jnp.asarray(x) for x in (u, v, w, lab)))
    exp_kern = jax_relabel(*(jnp.asarray(x) for x in (u, v, w, lab)),
                           block=block, interpret=True)
    args = tuple(_t(x) for x in (u, v, w, lab))
    for use_kernel in (False, True):
        got = relabel_edges(*args, use_kernel=use_kernel)
        _assert_equal(got, exp_ref, f"{ctx} use_kernel={use_kernel} vs ref")
        _assert_equal(got, exp_kern, f"{ctx} use_kernel={use_kernel} vs "
                      "Pallas")


@pytest.mark.parametrize("m,n", [(16, 8), (500, 100), (2048, 35000)])
@pytest.mark.parametrize("block", [128, 1024])
def test_relabel_matches_reference(m, n, block):
    _check_relabel(*_relabel_problem(m, n, m + block), block, (m, n))


def test_relabel_index_normalisation_and_dead_weights():
    """A negative index wraps once, then every index is clamped into the
    table: with n' = 10, u = -1, 10, 15, -13 read rows 9, 9, 9, 0.  NaN
    and -inf weights are dead, like self-loops."""
    lab = np.array([3, 3, 0, 7, 7, 5, 2, 9, 1, 4], np.int32)
    u = np.array([-1, 10, 15, -13, 0, 2, 4, 6], np.int32)
    v = np.array([0, -10, 2, 9, 1, 2, -3, 8], np.int32)
    w = np.array([1, 2, 3, 4, np.nan, -np.inf, 5, -0.0], np.float32)
    _check_relabel(u, v, w, lab, 8, "normalisation")
    ru, _, _ = relabel_ref(_t(u), _t(v), _t(w), _t(lab))
    np.testing.assert_array_equal(ru.numpy()[:4], lab[[9, 9, 9, 0]])


def test_relabel_empty():
    z = torch.zeros(0, dtype=torch.int32)
    zw = torch.zeros(0, dtype=torch.float32)
    for use_kernel in (False, True):
        ru, rv, wp = relabel_edges(z, z, zw, torch.arange(4, dtype=torch.int32),
                                   use_kernel=use_kernel)
        assert ru.shape == rv.shape == wp.shape == (0,)
        assert (ru.dtype, wp.dtype) == (torch.int32, torch.float32)
    with pytest.raises(ValueError, match="empty label table"):
        relabel(torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32), torch.ones(3), z)


# ---------------------------------------------------------------------------
# K3: segmin_candidates, and min_edges_dense on top of it
# ---------------------------------------------------------------------------

def _check_candidates(seg, w, eid, alive, block, ctx):
    """Blocked plain (the CPU wrapper) == Pallas at equal block; the
    array-wide plain == the JAX oracle."""
    jargs = tuple(jnp.asarray(x) for x in (seg, w, eid, alive))
    args = tuple(_t(x) for x in (seg, w, eid, alive))
    _assert_equal(segmin_candidates(*args, block=block),
                  jax_segmin(*jargs, block=block, interpret=True),
                  f"{ctx} blocked vs Pallas")
    _assert_equal(segmin_candidates_ref(*args), jax_seg_ref(*jargs),
                  f"{ctx} array-wide vs oracle")


def _check_dense(seg, w, eid, alive, n, block, ctx, w_torch=None):
    """min_edges_dense both ways == JAX's both ways."""
    jargs = tuple(jnp.asarray(x) for x in (seg, w, eid, alive))
    exp = jax_min_edges_dense(*jargs, n, block=block, interpret=True,
                              use_pallas=True)
    _assert_equal(jax_min_edges_dense(*jargs, n, use_pallas=False), exp,
                  f"{ctx} JAX both ways")
    args = [_t(seg), w_torch if w_torch is not None else _t(w), _t(eid),
            _t(alive)]
    for use_kernel in (True, False):
        got = min_edges_dense(*args, n, block=block, use_kernel=use_kernel)
        _assert_equal(got, exp, f"{ctx} use_kernel={use_kernel}")


@pytest.mark.parametrize("m", [8, 100, 512, 1000, 2048])
@pytest.mark.parametrize("block", [128, 512])
def test_segmin_candidates_match_reference(m, block):
    seg, w, eid, alive = _sorted_run_problem(m, max(4, m // 4),
                                             seed=m + block)
    _check_candidates(seg, w, eid, alive, block, (m, block))


@pytest.mark.parametrize("m", [8, 100, 512, 1000, 2048])
@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_min_edges_dense_matches_reference(m, block, w_dtype):
    n = max(4, m // 4)
    jdtype = jnp.float32 if w_dtype == "float32" else jnp.bfloat16
    seg, w, eid, alive = _sorted_run_problem(m, n, seed=m + block,
                                             w_dtype=jdtype)
    # the bf16 weights reach the port as bf16 holding the same values
    w32 = np.asarray(w.astype(jnp.float32))
    _check_dense(seg, w, eid, alive, n, block, (m, block, w_dtype),
                 w_torch=_t(w32).to(getattr(torch, w_dtype)))


def test_segmin_tie_heavy():
    seg, w, eid, alive = _sorted_run_problem(777, 50, seed=1, tie_heavy=True)
    _check_candidates(seg, w, eid, alive, 128, "tie heavy")
    _check_dense(seg, w, eid, alive, 50, 128, "tie heavy")


@pytest.mark.parametrize("m,block", [(1, 512), (7, 512), (13, 8),
                                     (1001, 8), (1001, 100), (3000, 1024),
                                     (5000, 4096)])
def test_segmin_ragged_blocks(m, block):
    """Blocks that do not divide m, blocks past m (shrunk to max(m, 8))
    and blocks above 1024 (several elements per CUDA thread)."""
    n = max(4, m // 4)
    seg, w, eid, alive = _sorted_run_problem(m, n, seed=m * 7 + block)
    _check_candidates(seg, w, eid, alive, block, (m, block))
    _check_dense(seg, w, eid, alive, n, block, (m, block))


def test_segmin_unsorted_piecewise_runs():
    """tests/test_kernels.py's piecewise seg, checked through the dense
    result, which is where the reference's kernel and oracle agree."""
    seg = np.repeat([5, 2, 9, 2, 0], [7, 3, 11, 4, 6]).astype(np.int32)
    m = seg.shape[0]
    w = np.random.default_rng(0).uniform(1, 9, m).astype(np.float32)
    eid = np.arange(m, dtype=np.int32)
    _check_dense(seg, w, eid, np.ones(m, bool), 10, 8, "piecewise")
    _assert_equal(segmin_candidates_ref(*(_t(x) for x in (
        seg, w, eid, np.ones(m, bool)))),
        jax_seg_ref(*(jnp.asarray(x) for x in (seg, w, eid,
                                                np.ones(m, bool)))),
        "piecewise array-wide vs oracle")


def test_segmin_runs_stay_contiguous_on_unsorted_seg():
    """seg = [5, 5, 2, 5]: the reference's kernel emits (1, 0) at index 3,
    taking in the first run of 5s across the 2; its oracle and the port
    emit that run's own minimum (9, 3).  The dense result agrees."""
    seg = np.array([5, 5, 2, 5], np.int32)
    w = np.array([1, 9, 9, 9], np.float32)
    eid = np.arange(4, dtype=np.int32)
    alive = np.ones(4, bool)
    args = tuple(_t(x) for x in (seg, w, eid, alive))
    for cand in (segmin_candidates(*args, block=8),
                 segmin_candidates_ref(*args)):
        assert (float(cand[0][3]), int(cand[1][3])) == (9.0, 3)
        _assert_equal(cand, jax_seg_ref(*(jnp.asarray(x) for x in (
            seg, w, eid, alive))), "vs oracle")
    _check_dense(seg, w, eid, alive, 8, 8, "unsorted")


def test_segmin_all_dead_inf_and_zeros():
    m, n = 64, 8
    seg = np.sort(np.random.default_rng(0).integers(0, n, m)).astype(
        np.int32)
    eid = np.arange(m, dtype=np.int32)
    w = np.full(m, 5.0, np.float32)
    _check_candidates(seg, w, eid, np.zeros(m, bool), 512, "all dead")
    _check_dense(seg, w, eid, np.zeros(m, bool), n, 512, "all dead")
    wmin, emin = min_edges_dense(*(_t(x) for x in (seg, w, eid,
                                                   np.zeros(m, bool))), n)
    assert not torch.isfinite(wmin).any()
    assert (emin == EID_SENTINEL).all()
    # an alive +inf lane still competes on eid: (inf, 3) at the run end
    seg3 = np.zeros(3, np.int32)
    inf3 = np.full(3, np.inf, np.float32)
    eid3 = np.array([7, 3, 5], np.int32)
    _check_candidates(seg3, inf3, eid3, np.ones(3, bool), 512, "inf alive")
    cw, ce = segmin_candidates(*(_t(x) for x in (seg3, inf3, eid3,
                                                 np.ones(3, bool))))
    assert (float(cw[2]), int(ce[2])) == (float("inf"), 3)
    # -0.0 and +0.0 tie: eid decides
    wz = np.array([0.0, -0.0, 0.0, 1.0], np.float32)
    segz = np.zeros(4, np.int32)
    eidz = np.array([9, 4, 6, 1], np.int32)
    _check_candidates(segz, wz, eidz, np.ones(4, bool), 512, "zeros")
    _check_dense(segz, wz, eidz, np.ones(4, bool), 2, 512, "zeros")


def test_segmin_candidates_rejects_bad_block():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="block"):
        segmin_candidates(z, torch.ones(4), z, torch.ones(4, dtype=torch.bool),
                          block=0)


# ---------------------------------------------------------------------------
# the relabel -> min-edge chain
# ---------------------------------------------------------------------------

def test_kernels_compose_one_boruvka_selection():
    """relabel -> segmin reproduces the library's min-edge selection
    (tests/test_kernels.py's chain, and JAX's outputs on it)."""
    from repro.core.boruvka import \
        min_edge_per_component as jax_min_edge_per_component
    from repro.kernels.relabel.ops import relabel_edges as jax_relabel_edges
    rng = np.random.default_rng(3)
    n, m = 64, 400
    u = np.sort(rng.integers(0, n, m)).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(1, 255, m).astype(np.float32)
    labels = torch.arange(n, dtype=torch.int32)
    ru, rv, wp = relabel_edges(_t(u), _t(v), _t(w), labels)
    eid = torch.arange(m, dtype=torch.int32)
    alive = torch.isfinite(wp)
    wmin_k, emin_k = min_edges_dense(ru, wp, eid, alive, n)
    wmin_l, _ = min_edge_per_component(ru, rv, _t(w), n)
    # the kernel reduces the src side only (directed representation);
    # the library reduces both sides of the canonical single-copy form —
    # compare on the src-side projection
    wmin_src = torch.full((n,), float("inf")).scatter_reduce_(
        0, ru.long(), torch.where(alive, wp, float("inf")), "amin")
    np.testing.assert_array_equal(wmin_k.numpy(), wmin_src.numpy())
    assert (wmin_l <= wmin_k).all()
    jl = jnp.arange(n, dtype=jnp.int32)
    jru, jrv, jwp = jax_relabel_edges(jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(w), jl, interpret=True)
    _assert_equal((ru, rv, wp), (jru, jrv, jwp), "relabel")
    jdense = jax_min_edges_dense(jru, jwp, jnp.arange(m, dtype=jnp.int32),
                                 jnp.isfinite(jwp), n, interpret=True)
    _assert_equal((wmin_k, emin_k), jdense, "dense")
    _assert_equal(min_edge_per_component(ru, rv, _t(w), n),
                  jax_min_edge_per_component(jru, jrv, jnp.asarray(w), n),
                  "min_edge_per_component")


@pytest.mark.parametrize("family", ["random", "dup_weights", "selfloops"])
def test_selection_rounds_equal_min_edge_per_component(family):
    """chip_smoke.py's phase 6 on the CPU at a family's size: the K2 -> K3
    selection on the directed both-copy list equals min_edge_per_component
    on the undirected list in every Borůvka round."""
    u, v, w, n = FAMILIES[family](0)
    res = chip_smoke.selection_rounds(torch.device("cpu"), u, v, w, n)
    assert res["rounds"] >= 2
    assert res["max_abs_err"] == 0.0


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(16, 8), (500, 100), (2048, 35000), (0, 4)])
def test_cuda_relabel_matches_plain(m, n):
    _need_gpu()
    args = [_t(x).cuda() for x in _relabel_problem(m, n, m)]
    before = relabel.launches
    got = relabel(*args)
    torch.cuda.synchronize()
    assert relabel.launches == before + (1 if m else 0)
    _assert_equal(tuple(t.cpu() for t in got),
                  tuple(t.cpu() for t in relabel_ref(*args)), (m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("m,block", [(1, 512), (7, 512), (13, 8), (100, 128),
                                     (1000, 512), (2048, 128), (1001, 100),
                                     (3000, 1024), (5000, 4096)])
def test_cuda_segmin_candidates_match_plain(m, block):
    _need_gpu()
    seg, w, eid, alive = (_t(x).cuda() for x in _sorted_run_problem(
        m, max(4, m // 4), seed=m + block, tie_heavy=bool(m % 2)))
    before = segmin_candidates.launches
    got = segmin_candidates(seg, w, eid, alive, block=block)
    torch.cuda.synchronize()
    assert segmin_candidates.launches == before + 1
    exp = segmin_candidates_ref(seg, w, eid, alive, min(block, max(m, 8)))
    _assert_equal(tuple(t.cpu() for t in got), tuple(t.cpu() for t in exp),
                  (m, block))
