"""The port's multicast primitives and per-axis all-to-all against the JAX
reference, bit for bit.

One module-scoped fixture runs the reference in a subprocess with 8
virtual CPU devices: ``scatter_updates`` on the one-axis layout ``(8,)``
and on ``(4, 2)`` (the grid schedule's hop multiplier),
``scatter_updates_grid`` on ``(4, 2)``, each with generous capacities
and with capacities pinned low (overflow), and with bit 30 set in the
masks (a destination no layout here has), on the conservation and
stats cases of tests/test_comm.py; and ``lax.all_to_all`` over each of
the two named axes.  The port must give the same received buffers,
``recv_ok``, ``sent_ok``, overflow and every ``ExchangeStats`` field.
The bitmask width helpers are held in process against the reference's
on the 31-shard and 961-shard contracts.
"""
import numpy as np
import pytest
import torch

from repro.comm import exchange as jax_exchange
from repro_torch.comm.exchange import (ExchangeStats, _axis_masks_to_copies,
                                       _mask_to_copies, scatter_updates,
                                       scatter_updates_grid)
from repro_torch.comm.grid_alltoall import all_to_all_axis
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

SHARDS = P = 8
STATS = ExchangeStats._fields
# (name, kind, layout, items per shard, capacities, seed, bit 30 set)
CASES = [
    ("flat_8", "flat", (8,), 64, (64,), 3, False),
    ("flat_8_overflow", "flat", (8,), 64, (5,), 4, False),
    ("flat_8_cap1_overflow_bit30", "flat", (8,), 33, (1,), 5, True),
    ("flat_4x2", "flat", (4, 2), 32, (32,), 6, False),
    ("flat_4x2_overflow_bit30", "flat", (4, 2), 40, (7,), 7, True),
    ("grid_4x2", "grid", (4, 2), 32, (64, 256), 11, False),
    ("grid_4x2_overflow", "grid", (4, 2), 48, (9, 13), 12, False),
    ("grid_4x2_row_overflow_bit30", "grid", (4, 2), 40, (6, 200), 13, True),
    ("grid_4x2_col_overflow_bit30", "grid", (4, 2), 40, (80, 11), 14, True),
]


def _inputs(kind, layout, L, seed, hi):
    """Two payload leaves (int32, float32), the masks and validity."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1000, SHARDS * L).astype(np.int32)
    b = rng.uniform(0, 1, SHARDS * L).astype(np.float32)
    valid = rng.random(SHARDS * L) < 0.7
    widths = (SHARDS,) if kind == "flat" else layout
    masks = []
    for d in widths:
        m = rng.integers(0, 2 ** d, SHARDS * L).astype(np.int64)
        if hi:
            m[rng.random(SHARDS * L) < 0.5] |= 1 << 30
        masks.append(m.astype(np.int32))
    return a, b, valid, masks


REFERENCE = """
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.exchange import (ExchangeStats, scatter_updates,
                                 scatter_updates_grid)

out = {}
for name, kind, layout, L, caps, seed, hi in CASES:
    a, b, valid, masks = _inputs(kind, layout, L, seed, hi)
    if len(layout) == 1:
        mesh, ax = Mesh(np.array(jax.devices()), ("data",)), ("data",)
    else:
        mesh = Mesh(np.array(jax.devices()).reshape(layout), ("row", "col"))
        ax = ("row", "col")

    def push(a, b, va, *m):
        if kind == "flat":
            upd = scatter_updates((a, b), m[0], va, caps[0], ax, "grid",
                                  stats=ExchangeStats.zeros())
        else:
            upd = scatter_updates_grid((a, b), m[0], m[1], va, caps[0],
                                       caps[1], ax,
                                       stats=ExchangeStats.zeros())
        return (upd.recv[0], upd.recv[1], upd.recv_ok, upd.sent_ok,
                upd.overflow) + tuple(upd.stats)

    f = jax.jit(shard_map(push, mesh=mesh,
                          in_specs=(P(ax),) * (3 + len(masks)),
                          out_specs=(P(ax),) * 4 + (P(),) * 9))
    res = f(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
            *(jnp.asarray(m) for m in masks))
    for k, x in zip(("recv_a", "recv_b", "recv_ok", "sent_ok", "overflow")
                    + STATS, res):
        out[f"{name}/{k}"] = np.asarray(x)

# one named axis of the (4, 2) mesh
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("row", "col"))
for axis, name, d in ((0, "row", 4), (1, "col", 2)):
    x = np.arange(SHARDS * d * 3, dtype=np.int32).reshape(SHARDS * d, 3)
    f = shard_map(lambda t: jax.lax.all_to_all(t, name, 0, 0), mesh=mesh,
                  in_specs=P(("row", "col")), out_specs=P(("row", "col")))
    out[f"a2a/{axis}"] = np.asarray(f(jnp.asarray(x)))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import inspect
    path = tmp_path_factory.mktemp("jax_reference_multicast") / "ref.npz"
    body = (f"OUT = {str(path)!r}\nCASES = {CASES!r}\nSTATS = {STATS!r}\n"
            f"SHARDS = {SHARDS}\n" + inspect.getsource(_inputs) + REFERENCE)
    assert "OK" in run_reference(body, ndev=P, timeout=600)
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_multicast_matches_reference(ref, case):
    name, kind, layout, L, caps, seed, hi = case
    a, b, valid, masks = _inputs(kind, layout, L, seed, hi)

    def t(x):
        return torch.from_numpy(x).view(P, L)

    if kind == "flat":
        upd = scatter_updates((t(a), t(b)), t(masks[0]), t(valid), caps[0],
                              layout, "grid", stats=ExchangeStats.zeros(
                                  torch.device("cpu")))
    else:
        upd = scatter_updates_grid((t(a), t(b)), t(masks[0]), t(masks[1]),
                                   t(valid), caps[0], caps[1], layout,
                                   stats=ExchangeStats.zeros(
                                       torch.device("cpu")))
    got = dict(recv_a=upd.recv[0], recv_b=upd.recv[1], recv_ok=upd.recv_ok,
               sent_ok=upd.sent_ok, overflow=upd.overflow)
    got.update(zip(STATS, upd.stats))
    for k, x in got.items():
        exp = ref[f"{name}/{k}"]
        x = x.numpy()
        if x.ndim:
            x = x.reshape(exp.shape)
        assert x.dtype == exp.dtype, (name, k, x.dtype, exp.dtype)
        np.testing.assert_array_equal(x, exp, err_msg=f"{name}/{k}")
    # the case's own contract: overflow where a capacity is pinned low
    low = "overflow" in name
    assert (int(upd.overflow) > 0) == low, (name, int(upd.overflow))


@pytest.mark.parametrize("axis", [0, 1])
def test_all_to_all_axis_matches_reference(ref, axis):
    d = (4, 2)[axis]
    x = torch.arange(P * d * 3, dtype=torch.int32).view(P, d, 3)
    got = all_to_all_axis(x, (4, 2), axis).reshape(P * d, 3).numpy()
    np.testing.assert_array_equal(got, ref[f"a2a/{axis}"])


def test_mask_width_to_31_shards():
    """The flat copy matrix to the full 31-destination width, bit 30 (the
    last before the sign bit) included, against the reference's."""
    rng = np.random.default_rng(5)
    L, p = 96, 31
    masks = rng.integers(0, 1 << 31, L, dtype=np.int64)
    masks[0], masks[1], masks[2] = 0, (1 << 31) - 1, 1 << 30
    masks = masks.astype(np.int32)
    valid = rng.random(L) < 0.8
    valid[1] = valid[2] = True
    exp = np.asarray(jax_exchange._mask_to_copies(masks, valid, p))
    got = _mask_to_copies(torch.from_numpy(masks), torch.from_numpy(valid),
                          p).numpy()
    np.testing.assert_array_equal(got, exp)
    assert got.shape == (L, p)
    assert got[2, 30] and got[2, :30].sum() == 0
    assert got[1].all()
    # stacked shards: each row on its own
    two = _mask_to_copies(torch.from_numpy(masks).view(2, 48),
                          torch.from_numpy(valid).view(2, 48), p)
    np.testing.assert_array_equal(two.reshape(L, p).numpy(), exp)


def test_axis_masks_961_shard_contract():
    """The per-axis copy matrices to 31 x 31 shards against the
    reference's: bit 30 on both axes, and an empty row mask that kills
    the cross product whatever the column mask."""
    rng = np.random.default_rng(12)
    L, r, c = 64, 31, 31
    rmask = rng.integers(0, 1 << 31, L, dtype=np.int64)
    cmask = rng.integers(0, 1 << 31, L, dtype=np.int64)
    rmask[0], cmask[0] = 0, 0
    rmask[1], cmask[1] = (1 << 31) - 1, (1 << 31) - 1
    rmask[2], cmask[2] = 1 << 30, 1 << 30
    rmask[3], cmask[3] = 0, (1 << 31) - 1
    rmask, cmask = rmask.astype(np.int32), cmask.astype(np.int32)
    valid = rng.random(L) < 0.8
    valid[1] = valid[2] = valid[3] = True
    exp = jax_exchange._axis_masks_to_copies(rmask, cmask, valid, r, c)
    got = _axis_masks_to_copies(torch.from_numpy(rmask),
                                torch.from_numpy(cmask),
                                torch.from_numpy(valid), r, c)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    rc, cc = (g.numpy() for g in got)
    assert int(rc[1].sum()) * int(cc[1].sum()) == 961
    assert rc[2, 30] and cc[2, 30] and rc[2].sum() == 1 and cc[2].sum() == 1
    assert rc[3].sum() == 0 and cc[3].sum() == c
