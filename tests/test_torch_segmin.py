"""K1 (the fused MINEDGES scatter-min) in the port: its plain PyTorch
version against the JAX reference's sequential oracle
(``owner_scatter_min_ref``) and Pallas kernel (interpret mode), on the
wall of tests/test_kernels_fuzz.py; plus ``run_metadata`` and the
dispatcher.  Exact equality throughout (``-0.0 == +0.0``).

The CUDA kernel itself runs only on the card: ``test_cuda_kernel_*``
hold it against the plain version there and skip without a GPU
(``python3 chip_smoke.py`` runs the same comparison on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segmin.ops import run_metadata as jax_run_metadata
from repro.kernels.segmin.ref import owner_scatter_min_ref as jax_ref
from repro.kernels.segmin.segmin import owner_scatter_min as jax_kernel
from repro_torch.kernels.segmin.ops import run_metadata, scatter_min_tables
from repro_torch.kernels.segmin.ref import (EID_SENTINEL,
                                            owner_scatter_min_ref)
from repro_torch.kernels.segmin.segmin import owner_scatter_min
from tests.test_kernels_fuzz import BLOCKS, _random_candidates

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_tables_equal(got, exp, ctx):
    for name, g, e in zip(("wmin", "emin", "pay1", "pay2"), got, exp):
        g = g.numpy()
        e = np.asarray(e)
        assert g.dtype == e.dtype, (ctx, name, g.dtype, e.dtype)
        np.testing.assert_array_equal(g, e, err_msg=f"{ctx}: {name}")


def _check(idx, w, eid, pay1, pay2, ok, size, block, out_block, ctx):
    """Port's plain version == JAX sequential oracle == JAX kernel."""
    got = owner_scatter_min_ref(_t(idx), _t(w), _t(eid), _t(pay1),
                                _t(pay2), _t(ok), size)
    jargs = tuple(jnp.asarray(x) for x in (idx, w, eid, pay1, pay2, ok))
    _assert_tables_equal(got, jax_ref(*jargs, size), f"{ctx}: vs oracle")
    kern = jax_kernel(*jargs, size, block=block, out_block=out_block,
                      interpret=True)
    _assert_tables_equal(got, kern, f"{ctx}: vs Pallas kernel")


@pytest.mark.parametrize("seed", range(8))
def test_plain_matches_reference_sweep(seed):
    block, out_block = BLOCKS[seed % len(BLOCKS)]
    rng = np.random.default_rng(seed * 1000 + block)
    L = int(rng.integers(0, 300))
    size = int(rng.integers(1, 64))
    cand = _random_candidates(rng, L, size, tie_heavy=bool(seed % 2),
                              inf_tail=bool(seed % 3 == 0))
    _check(*cand, size, block, out_block, (seed, L, size))


@pytest.mark.parametrize("block,out_block", BLOCKS)
def test_plain_matches_reference_adversarial(block, out_block):
    rng = np.random.default_rng(7)
    cases = {
        "empty_shard": (0, 8),
        "single_candidate": (1, 4),
        "single_slot_table": (37, 1),
        "block_exact": (block, out_block),
        "block_plus_one": (block + 1, out_block),
        "block_minus_one": (max(block - 1, 1), out_block),
    }
    for name, (L, size) in cases.items():
        cand = _random_candidates(rng, L, size, tie_heavy=True,
                                  inf_tail=True)
        _check(*cand, size, block, out_block, name)
    L, size = 50, 16
    idx, w, eid, p1, p2, _ = _random_candidates(rng, L, size, False, False)
    _check(idx, w, eid, p1, p2, np.zeros(L, bool), size, block, out_block,
           "all_dead")


def test_plain_matches_reference_tie_storm():
    """Every candidate on one slot with one weight: the winner is pure
    eid order, and equal-eid duplicates take the max payload."""
    L, size = 96, 4
    idx = np.full(L, 2, np.int32)
    w = np.full(L, 5.0, np.float32)
    eid = np.concatenate([np.full(L // 2, 11, np.int32),
                          np.arange(L // 2, dtype=np.int32) + 11])
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, 100, L).astype(np.int32)
    p2 = rng.integers(0, 100, L).astype(np.int32)
    _check(idx, w, eid, p1, p2, np.ones(L, bool), size, 16, 32, "tie_storm")


def test_plain_signed_zero_and_inf_tail():
    """-0.0 ties +0.0 (the winner is decided by eid), and an ok lane
    with w = +inf still competes on eid."""
    idx = np.array([0, 0, 0, 1, 1, 2], np.int32)
    w = np.array([0.0, -0.0, 1.0, np.inf, np.inf, 3.0], np.float32)
    eid = np.array([9, 4, 1, 8, 6, 2], np.int32)
    pay = np.array([10, 20, 30, 40, 50, 60], np.int32)
    ok = np.array([True, True, True, True, True, False])
    _check(idx, w, eid, pay, pay, ok, 4, 8, 8, "signed_zero")
    wt, et, p1, _ = owner_scatter_min_ref(_t(idx), _t(w), _t(eid), _t(pay),
                                          _t(pay), _t(ok), 4)
    assert et.tolist() == [4, 6, EID_SENTINEL, EID_SENTINEL]
    assert p1.tolist() == [20, 50, -1, -1]


def test_plain_zero_size_and_empty():
    z = np.zeros(0, np.int32)
    got = owner_scatter_min_ref(_t(z), _t(z.astype(np.float32)), _t(z),
                                _t(z), _t(z), _t(z.astype(bool)), 5)
    assert got[0].shape == (5,) and torch.isinf(got[0]).all()
    assert (got[1] == EID_SENTINEL).all() and (got[2] == -1).all()
    one = (_t(np.array([0], np.int32)), _t(np.array([1.0], np.float32)),
           _t(np.array([3], np.int32)), _t(np.array([7], np.int32)),
           _t(np.array([9], np.int32)), _t(np.array([True])))
    got = owner_scatter_min_ref(*one, 0)
    assert all(t.shape == (0,) for t in got)


def test_plain_stacked_rows_match_per_row_reference():
    """One call over stacked shards ([S, L]) equals the reference run
    shard by shard — the layout the engine hands the kernel."""
    rng = np.random.default_rng(5)
    S, L, size = 4, 120, 9
    rows = [_random_candidates(rng, L, size, True, True) for _ in range(S)]
    stacked = [np.stack([r[k] for r in rows]) for k in range(6)]
    got = owner_scatter_min_ref(*(_t(x) for x in stacked), size)
    for s in range(S):
        exp = jax_ref(*(jnp.asarray(x) for x in rows[s]), size)
        _assert_tables_equal(tuple(g[s] for g in got), exp, f"row {s}")


def _out_of_range_rows(rng, S, L, size):
    """Stacked candidate rows in which some ok lanes point past either
    end of the table: a lane at ``size + k`` would be the next row's
    slot ``k`` if it were not dropped."""
    rows = []
    for _ in range(S):
        idx, w, eid, p1, p2, ok = _random_candidates(rng, L, size, True,
                                                     False)
        idx[::7] += size
        idx[3::11] = -1 - idx[3::11]
        rows.append((idx, w, eid, p1, p2, ok))
    return rows


@pytest.mark.parametrize("block,out_block", BLOCKS[:2])
def test_plain_drops_out_of_range_lanes_like_pallas(block, out_block):
    """An ok lane with idx outside [0, size) is dropped, as the Pallas
    kernel drops it (its one-hot match never hits), and never lands in
    another row's slots.  The sequential oracle clips such a lane
    instead; the engine never sends one."""
    S, L, size = 3, 200, 13
    rows = _out_of_range_rows(np.random.default_rng(11), S, L, size)
    stacked = [np.stack([r[k] for r in rows]) for k in range(6)]
    got = owner_scatter_min_ref(*(_t(x) for x in stacked), size)
    for s in range(S):
        exp = jax_kernel(*(jnp.asarray(x) for x in rows[s]), size,
                         block=block, out_block=out_block, interpret=True)
        _assert_tables_equal(tuple(g[s] for g in got), exp, f"row {s}")


def test_dispatcher_and_wrapper_on_cpu_use_plain_version():
    rng = np.random.default_rng(3)
    cand = tuple(_t(x) for x in _random_candidates(rng, 130, 12, True, True))
    before = owner_scatter_min.launches
    via_kernel = scatter_min_tables(*cand, 12, use_kernel=True)
    via_plain = scatter_min_tables(*cand, 12, use_kernel=False)
    _assert_tables_equal(via_kernel, via_plain, "dispatcher")
    _assert_tables_equal(owner_scatter_min(*cand, 12), via_plain, "wrapper")
    # the plain version is not a kernel launch
    assert owner_scatter_min.launches == before


@pytest.mark.parametrize("values", [
    [], [42], [3, 3, 1, 1, 1, 7, 3, 3], list(range(6)), [5] * 9])
def test_run_metadata_matches_reference(values):
    a = np.asarray(values, np.int32)
    exp = jax_run_metadata(jnp.asarray(a))
    got = run_metadata(_t(a))
    for name, g, e in zip(("head", "head_idx", "run_id"), got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=name)
        assert g.numpy().dtype == np.asarray(e).dtype


def test_run_metadata_with_perm_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 6, 40).astype(np.int32)
    perm = np.argsort(a, kind="stable").astype(np.int32)
    exp = jax_run_metadata(jnp.asarray(a), perm=jnp.asarray(perm))
    got = run_metadata(_t(a), perm=_t(perm))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_cuda_kernel_matches_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(seed)
    L = int(rng.integers(0, 3000))
    size = int(rng.integers(1, 64))
    cand = [_t(x).cuda() for x in _random_candidates(
        rng, L, size, tie_heavy=bool(seed % 2), inf_tail=True)]
    before = owner_scatter_min.launches
    got = owner_scatter_min(*cand, size)
    torch.cuda.synchronize()
    assert owner_scatter_min.launches == before + (1 if L else 0)
    exp = owner_scatter_min_ref(*cand, size)
    _assert_tables_equal(tuple(t.cpu() for t in got),
                         tuple(t.cpu() for t in exp), f"seed {seed}")


@pytest.mark.cuda
def test_cuda_kernel_drops_out_of_range_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rows = _out_of_range_rows(np.random.default_rng(11), 3, 2000, 13)
    cand = [_t(np.stack([r[k] for r in rows])).cuda() for k in range(6)]
    got = owner_scatter_min(*cand, 13)
    exp = owner_scatter_min_ref(*cand, 13)
    _assert_tables_equal(tuple(t.cpu() for t in got),
                         tuple(t.cpu() for t in exp), "out of range")
