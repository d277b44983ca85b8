"""The design of the K1 and K3 CUDA kernels, checked without a card.

A CUDA kernel runs only on the card, so what surrounds it is held here:

* the host-side launch plans of ``kernels/segmin/plan.py`` — the wide
  or scalar path by alignment, the span of blocks a K3 CTA covers and
  that every element lies in exactly one thread's chunk, the grid, the
  payload-aliasing flag and the capacity of K1's candidate list — and
  the build's ``-D`` flags, which hand plan.py's constants to the
  kernels, and the count of the lanes K1 listed;
* a numpy model of K3's decomposition (chunks of ``K3_E`` elements,
  warp scans of a head-flag carry, warp totals, the tile carry and the
  held last chunk), transcribed from ``csrc/segmin_candidates.cu`` and
  held to the plain version ``segmin_candidates_ref``, plus the
  associativity of the carry operator;
* a property of K1's first pass: under any arrival order, and with
  stale reads, the lanes it lists include every lane that ties its
  slot's final minimum, so the list-driven payload pass is exact.

``chip_smoke.py`` holds the kernels themselves to the plain versions on
the card, on the same walls.  The tests marked ``cuda`` run the kernels'
paths on the card, and the sharded lever path through K1 at both of its
MINEDGES sites (this file imports no JAX, so they run where there is a
card and no JAX); they skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segmin.plan import (CUDA_CONSTANTS, K1_CHUNK,
                                             K1_THREADS, K3_E, K3_THREADS,
                                             K3_TILE, k1_list_capacity,
                                             k1_plan, k3_plan)
from repro_torch.kernels.segmin.ref import (EID_SENTINEL,
                                            owner_scatter_min_ref,
                                            segmin_candidates_ref)
from repro_torch.kernels.segmin.segmin import (ListUse, list_use,
                                               owner_scatter_min_list_use)
from tests.helpers.hypothesis_compat import given, settings, st

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

ALIGNED = [1 << 20] * 6
NO_KEY = np.iinfo(np.int64).max  # the kernels' ~0 in pack_keys' order
WARPS = K3_THREADS // 32

# (m, block) of chip_smoke.py's K3 wall and of tests/test_torch_kernels.py
K3_WALL = ([(m, b) for m in (8, 100, 512, 1000, 2048) for b in (128, 512)]
           + [(777, 128), (31, 8), (3000, 512), (1, 512), (7, 512)]
           + [(10007, b) for b in (8, 100, 1024, 4096)]
           + [(10007, b) for b in (3, 4, 5, 13, 516)]
           + [(13, 8), (1001, 100), (3000, 1024), (5000, 4096),
              (1 << 24, 512)])


def _block(m, block):
    return min(block, max(m, 8))


def pack_keys(w, eid):
    """int64 keys in the kernels' ``(w, eid)`` order: an order-preserving
    uint32 of ``w`` (``-0.0`` folded onto ``+0.0``) above ``eid`` with its
    sign bit flipped, as ``pack`` in both ``.cu`` files builds them, then
    the sign bit flipped so that signed order is the unsigned order."""
    b = w.to(torch.float32).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    hi = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    lo = (eid.long() & 0xFFFFFFFF) ^ 0x80000000
    return ((hi << 32) | lo) ^ (-(1 << 63))


def k3_chunks(m, plan):
    """``(cta, first element)`` of every chunk that holds an element, as
    segmin_candidates_kernel walks them: CTA c covers its span tile by
    tile, thread t of a tile the K3_E elements from t0 + t K3_E on."""
    for cta in range(plan.ctas):
        s0 = cta * plan.span
        s1 = min(m, s0 + plan.span)
        for t0 in range(s0, s1, K3_TILE):
            for t in range(K3_THREADS):
                if t0 + t * K3_E < s1:
                    yield cta, t0 + t * K3_E


# ---------------------------------------------------------------------------
# (i) launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,block", K3_WALL)
def test_k3_plan_covers_every_element_once(m, block):
    block = _block(m, block)
    plan = k3_plan(m, block, ALIGNED)
    assert plan.span % block == 0 or plan.span == block
    assert plan.ctas * plan.span >= m > (plan.ctas - 1) * plan.span
    if m > 1 << 16:  # the engine's shape: one whole tile a CTA, 16 B loads
        assert (plan.span, plan.vec) == (K3_TILE, True)
        return
    seen = np.zeros(m, np.int64)
    for cta, c0 in k3_chunks(m, plan):
        end = min(c0 + K3_E, (cta + 1) * plan.span, m)
        assert c0 < end
        seen[c0:end] += 1
        # a chunk never straddles two CTAs' spans
        assert c0 // plan.span == (end - 1) // plan.span == cta
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("block,span,vec", [
    (512, 512, True), (4, 512, True), (8, 512, True), (128, 512, True),
    (3, 504, True), (5, 500, True), (13, 468, True), (100, 500, True),
    (516, 516, True), (1024, 1024, True), (4096, 4096, True),
    (257, 257, False), (1001, 1001, False), (511, 511, False),
    (1, 512, True), (2, 512, True), (6, 504, True)])
def test_k3_plan_path_by_block(block, span, vec):
    """A span holds whole blocks and, where a multiple of K3_E allows
    it, keeps every chunk on a 16-byte boundary."""
    plan = k3_plan(1 << 20, block, ALIGNED)
    assert (plan.span, plan.vec) == (span, vec)
    assert plan.span <= max(K3_TILE, block)


@pytest.mark.parametrize("bad", range(6))
def test_k3_plan_scalar_when_a_pointer_is_off(bad):
    ptrs = list(ALIGNED)
    ptrs[bad] += 4 if bad != 3 else 1  # one int32 / one bool further
    assert not k3_plan(1 << 20, 512, ptrs).vec
    if bad == 3:  # alive needs only 4-byte alignment
        ptrs[bad] += 3
        assert k3_plan(1 << 20, 512, ptrs).vec


def test_k3_plan_rejects_bad_block():
    with pytest.raises(ValueError):
        k3_plan(10, 0, ALIGNED)


@pytest.mark.parametrize("L,ptr_off,vec", [
    (1 << 25, 0, True), (16, 0, True), (4096, 0, True),
    (1, 0, False), (15, 0, False), (17, 0, False), (4097, 0, False),
    (4096, 4, False), (4096, 1, False)])
def test_k1_plan_path_by_row_and_alignment(L, ptr_off, vec):
    ptrs = [1 << 20, 1 << 21, 1 << 22, (1 << 23) + ptr_off]
    if ptr_off == 4:
        ptrs = [p + 4 for p in ptrs]
    assert k1_plan(8, L, 300, ptrs, False, 132).vec == vec


def test_k1_plan_grid_and_alias():
    # the engine's shape: 8 rows of 2^25 lanes, 2^17 slots a row
    plan = k1_plan(8, 1 << 25, 1 << 17, ALIGNED[:4], True, 132)
    assert plan.alias and plan.threads == K1_THREADS
    assert plan.grid == (132, 8)  # 8 CTAs an SM, rows along y
    small = k1_plan(3, 17, 13, ALIGNED[:4], False, 132)
    assert not small.alias and small.grid == (1, 3)
    many_rows = k1_plan(70000, 16, 4, ALIGNED[:4], False, 132)
    assert many_rows.grid[1] == 65535  # y steps over the rest


def test_k1_list_capacity():
    rows, L, size = 8, 1 << 25, 1 << 17
    plan = k1_plan(rows, L, size, ALIGNED[:4], True, 132)
    slots = rows * size
    # ln(2^28 / 2^20) = 5.5 -> 6, + 2 entries a slot, + the warps'
    # part-used reservations
    waste = 132 * 8 * (K1_THREADS // 32) * K1_CHUNK
    assert plan.capacity == 8 * slots + waste
    # H(32) ~ 4.06 listed lanes a slot for 32 ok lanes in random order
    assert plan.capacity > 1.5 * 4.06 * slots
    # never more than every lane, plus the reservations
    assert k1_list_capacity(1, 100, 50, 1) == 100 + 8 * K1_CHUNK
    # no list where an index would not fit an entry's 32 bits
    assert k1_list_capacity(2, 1 << 31, 4, 4) == 0
    assert k1_list_capacity(1 << 16, 4, 1 << 16, 4) == 0
    assert k1_list_capacity(0, 4, 4, 1) == 0


@pytest.mark.parametrize("name", sorted(CUDA_CONSTANTS))
def test_build_passes_the_plan_constants(name):
    """The kernels take their launch constants from plan.py alone: the
    build passes each as a -D flag, and the source defines none of them
    and refuses to compile without them."""
    flags = _build.flags(name)
    src = _build.SOURCES[name].read_text()
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    for k, v in CUDA_CONSTANTS[name].items():
        assert f"-D{k}={v}" in flags
        assert f"defined({k})" in src and "#error" in src
        assert f"#define {k}" not in src


def test_library_path_follows_the_plan_constants(monkeypatch):
    """A changed constant names another library, so it is rebuilt."""
    before = _build.library_path("segmin_candidates")
    monkeypatch.setitem(CUDA_CONSTANTS, "segmin_candidates",
                        {**CUDA_CONSTANTS["segmin_candidates"],
                         "K3_THREADS": 2 * K3_THREADS})
    assert _build.library_path("segmin_candidates") != before


def test_k1_list_use_counts_listed_lanes_not_reserved_entries():
    """Warps reserve K1_CHUNK entries at a time; the unused rest of a
    reservation has the slot kNoSlot (-1) and is not a listed lane."""
    cap = 3 * K1_CHUNK
    entries = torch.full((cap * 4,), 7, dtype=torch.int32)
    view = entries.view(-1, 4)
    view[:2 * K1_CHUNK, 2] = torch.arange(2 * K1_CHUNK)
    view[200:2 * K1_CHUNK, 2] = -1
    assert list_use(entries, 2 * K1_CHUNK, cap) == ListUse(
        2 * K1_CHUNK, 200, cap)
    # overflowed (the payloads took the full pass), or no list at all
    assert list_use(entries, 4 * K1_CHUNK, cap).listed is None
    assert list_use(entries, 0, 0) == ListUse(0, None, 0)


def test_k1_list_use_on_the_cpu_runs_the_plain_version():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 9, (2, 50)).astype(np.int32),
        rng.integers(1, 4, (2, 50)).astype(np.float32),
        rng.integers(0, 20, (2, 50)).astype(np.int32),
        rng.integers(0, 99, (2, 50)).astype(np.int32),
        rng.integers(0, 99, (2, 50)).astype(np.int32),
        rng.random((2, 50)) < 0.6)]
    got, use = owner_scatter_min_list_use(*args, 9)
    assert use is None
    for g, e in zip(got, owner_scatter_min_ref(*args, 9)):
        assert torch.equal(g, e)


def test_pack_keys_order_is_the_lexicographic_order():
    w = torch.tensor([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, 2.0, np.inf,
                      np.inf, 5.0], dtype=torch.float32)
    e = torch.tensor([3, 1, 9, 4, 7, 2, 1, 0, 2 ** 30, -1],
                     dtype=torch.int32)
    k = pack_keys(w, e)
    order = sorted(range(len(w)), key=lambda i: (float(w[i]), int(e[i])))
    assert [int(k[i]) for i in order] == sorted(int(x) for x in k)
    assert int(k[2]) == int(pack_keys(torch.tensor([0.0]),
                                      torch.tensor([9], dtype=torch.int32)))
    assert int(pack_keys(torch.tensor([float("nan")]).view(torch.int32)
                         .bitwise_or(0x7fffffff).view(torch.float32),
                         torch.tensor([2 ** 31 - 1], dtype=torch.int32))
               ) == NO_KEY


# ---------------------------------------------------------------------------
# (ii) K3: a numpy model of the kernel's decomposition
# ---------------------------------------------------------------------------

def _combine(a, b):
    """(head, key) of stretch ``a`` directly before ``b``."""
    return a[0] | b[0], (b[1] if b[0] else min(a[1], b[1]))


def _warp_inclusive_scan(carries):
    """Hillis-Steele over 32 lanes, as the shuffle loop runs it."""
    inc = list(carries)
    d = 1
    while d < 32:
        up = [inc[max(lane - d, 0)] for lane in range(32)]
        inc = [_combine(up[lane], inc[lane]) if lane >= d else inc[lane]
               for lane in range(32)]
        d *= 2
    return inc


def k3_model(seg, w, eid, alive, block):
    """Candidate keys as segmin_candidates_kernel computes them: for every
    element, the packed key of its run's minimum at a run end, of
    (+inf, 2^30) elsewhere."""
    m = len(seg)
    plan = k3_plan(m, block, ALIGNED)
    dead = int(pack_keys(torch.tensor([np.inf]),
                         torch.tensor([EID_SENTINEL], dtype=torch.int32)))
    keys = pack_keys(torch.from_numpy(w), torch.from_numpy(eid)).numpy()
    keys = np.where(alive, keys, dead)
    out = np.full(m, dead, np.int64)
    for cta in range(plan.ctas):
        s0 = cta * plan.span
        s1 = min(m, s0 + plan.span)
        carry, before_tile, hold = (1, NO_KEY), 0, None
        for t0 in range(s0, s1, K3_TILE):
            sg = np.zeros((K3_THREADS, K3_E), np.int64)
            k = np.full((K3_THREADS, K3_E), NO_KEY, np.int64)
            start = np.zeros((K3_THREADS, K3_E + 1), bool)
            for t in range(K3_THREADS):
                c0 = t0 + t * K3_E
                for j in range(K3_E + 1):
                    start[t, j] = (c0 + j - s0) % block == 0
                    if j < K3_E and c0 + j < s1:
                        sg[t, j] = seg[c0 + j]
                        k[t, j] = keys[c0 + j]
            lane = np.arange(K3_THREADS) % 32
            warp = np.arange(K3_THREADS) // 32
            # shuffles: a lane past the warp's edge reads its own value
            prev = np.where(lane > 0, np.roll(sg[:, -1], 1), sg[:, -1])
            nxt = np.where(lane < 31, np.roll(sg[:, 0], -1), sg[:, 0])
            head = np.zeros((K3_THREADS, K3_E), bool)
            head[:, 0] = start[:, 0] | (sg[:, 0] != prev)
            head[:, 1:] = start[:, 1:K3_E] | (sg[:, 1:] != sg[:, :-1])
            mine = []
            for t in range(K3_THREADS):
                c = (int(lane[t] > 0 and head[t, 0]), int(k[t, 0]))
                for j in range(1, K3_E):
                    c = _combine(c, (int(head[t, j]), int(k[t, j])))
                mine.append(c)
            inc = []
            for v in range(WARPS):
                inc += _warp_inclusive_scan(mine[32 * v:32 * v + 32])
            first_seg = sg[::32, 0]
            last_seg = sg[31::32, -1]
            lead_start = start[::32, 0]
            pre, before_warp, lead_head = carry, [], []
            for v in range(WARPS):
                ps = last_seg[v - 1] if v else before_tile
                h = int(lead_start[v] or first_seg[v] != ps)
                pre = _combine(pre, (h, NO_KEY))
                before_warp.append(pre)
                lead_head.append(h)
                pre = _combine(pre, inc[32 * v + 31])
            if hold is not None:
                hc0, hkey, hseg, hstart, hout = hold
                hout[-1] = hkey if hstart or first_seg[0] != hseg else dead
                n = min(K3_E, s1 - hc0)
                out[hc0:hc0 + n] = hout[:n]
                hold = None
            for t in range(K3_THREADS):
                c0 = t0 + t * K3_E
                if c0 >= s1:
                    continue
                lt, wt = lane[t], warp[t]
                if lt == 0:
                    head[t, 0] = lead_head[wt]
                    run = before_warp[wt][1]
                else:
                    run = _combine(before_warp[wt], inc[t - 1])[1]
                after = nxt[t]
                if lt == 31 and wt + 1 < WARPS:
                    after = first_seg[wt + 1]
                o = np.full(K3_E, dead, np.int64)
                for j in range(K3_E):
                    run = k[t, j] if head[t, j] else min(run, k[t, j])
                    i = c0 + j
                    if i + 1 >= s1:
                        end = True
                    elif j + 1 < K3_E:
                        end = head[t, j + 1]
                    else:
                        end = start[t, K3_E] or after != sg[t, -1]
                    if end:
                        o[j] = run
                    if i + 1 >= s1:
                        break
                if t == K3_THREADS - 1 and t0 + K3_TILE < s1:
                    hold = (c0, run, sg[t, -1], start[t, K3_E], o)
                else:
                    n = min(K3_E, s1 - c0)
                    out[c0:c0 + n] = o[:n]
            carry, before_tile = pre, last_seg[-1]
    return out


def _ref_keys(seg, w, eid, alive, block):
    cw, ce = segmin_candidates_ref(*(torch.from_numpy(x)
                                     for x in (seg, w, eid, alive)), block)
    return pack_keys(cw, ce).numpy()


def _runs(rng, m, n, tie_heavy=False, alive_p=0.8):
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    w = (rng.integers(1, 4, m) if tie_heavy
         else rng.uniform(1, 255, m)).astype(np.float32)
    return seg, w, rng.permutation(m).astype(np.int32), rng.random(m) < alive_p


@pytest.mark.parametrize("m,block,n,tie", [
    (1, 512, 3, False), (7, 512, 3, True), (13, 8, 4, False),
    (777, 128, 50, True), (1000, 512, 250, False),
    (2100, 3, 500, True), (2100, 4, 30, False), (2100, 5, 200, True),
    (2100, 13, 9, False), (2100, 516, 40, True), (2100, 1024, 4, False),
    (2600, 257, 60, True), (1300, 4096, 2, False)])
def test_k3_model_matches_plain_version(m, block, n, tie):
    rng = np.random.default_rng(m * 31 + block)
    args = _runs(rng, m, n, tie)
    block = _block(m, block)
    np.testing.assert_array_equal(k3_model(*args, block),
                                  _ref_keys(*args, block))


def test_k3_model_runs_across_chunks_warps_and_tiles():
    """Long runs that cross thread chunks, warps and (block 2048) tiles,
    unsorted seg whose values recur, +inf and signed-zero weights, dead
    stretches."""
    lens = [1, 3, 4, 5, 127, 128, 129, 600, 2, 1100, 33]
    vals = [5, 2, 9, 2, 0, 7, 0, 3, 3, 1, 2]
    seg = np.repeat(vals, lens).astype(np.int32)
    m = len(seg)
    rng = np.random.default_rng(1)
    w = rng.choice(np.array([0.0, -0.0, 1.0, np.inf], np.float32), m)
    eid = rng.integers(0, 50, m).astype(np.int32)
    alive = rng.random(m) < 0.7
    alive[700:900] = False
    for block in (8, 100, 512, 513, 2048):
        np.testing.assert_array_equal(
            k3_model(seg, w, eid, alive, block),
            _ref_keys(seg, w, eid, alive, block), err_msg=str(block))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, 6)), min_size=3,
                max_size=3))
def test_k3_carry_operator_is_associative(triple):
    a, b, c = triple
    assert _combine(_combine(a, b), c) == _combine(a, _combine(b, c))


# ---------------------------------------------------------------------------
# (iii) K1: the list filter keeps every lane that can win
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3)),
                min_size=1, max_size=40),
       st.randoms(use_true_random=False))
def test_k1_filter_lists_every_lane_that_ties_the_minimum(lanes, rnd):
    """One slot's lanes arrive in runs of 1 to 4 (the lanes a thread
    holds side by side), the runs in a random order.  Only a run's
    minimum competes: the run reads the slot's key -- any value the slot
    has held, since a read may be stale -- and, where its minimum is
    lower, lowers the key with an atomicMin that returns the value at
    that moment.  The lanes at the run's minimum that are at most the
    value seen are listed."""
    w = torch.tensor([float(x) for x, _ in lanes])
    eid = torch.tensor([e for _, e in lanes], dtype=torch.int32)
    keys = [int(x) for x in pack_keys(w, eid)]
    cuts = sorted(rnd.sample(range(1, len(keys)), min(len(keys) - 1,
                                                      len(keys) // 2)))
    runs = [list(range(a, b)) for a, b in zip([0] + cuts,
                                              cuts + [len(keys)])]
    runs = [r[i:i + 4] for r in runs for i in range(0, len(r), 4)]
    history = [NO_KEY]
    listed = set()
    for run in rnd.sample(runs, len(runs)):
        low = min(keys[i] for i in run)
        seen = rnd.choice(history)
        if low < seen:
            seen = history[-1]
            history.append(min(seen, low))
        listed |= {i for i in run if keys[i] == low <= seen}
    final = history[-1]
    assert final == min(keys)
    winners = {i for i, k in enumerate(keys) if k == final}
    assert winners <= listed


# ---------------------------------------------------------------------------
# the kernels' new paths on the card (skipped without one)
# ---------------------------------------------------------------------------

def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("L,offset,alias", [(4096, 0, True), (4096, 1, False),
                                            (4097, 0, True), (15, 0, False)])
def test_cuda_k1_paths_match_plain(L, offset, alias):
    """The 16-lane and scalar paths, aliased payloads and a pointer one
    element off 16 bytes, against the plain version."""
    _need_gpu()
    from repro_torch.kernels.segmin.ref import owner_scatter_min_ref
    from repro_torch.kernels.segmin.segmin import owner_scatter_min
    rng = np.random.default_rng(L + offset)
    n = L + offset
    args = [torch.from_numpy(a).cuda()[offset:] for a in (
        rng.integers(0, 40, n).astype(np.int32),
        rng.integers(1, 4, n).astype(np.float32),
        rng.integers(0, 50, n).astype(np.int32),
        rng.integers(0, 99, n).astype(np.int32),
        rng.integers(0, 99, n).astype(np.int32), rng.random(n) < 0.7)]
    if alias:
        args[4] = args[3]
    got = owner_scatter_min(*args, 40)
    exp = owner_scatter_min_ref(*args, 40)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_cuda_k1_list_use():
    """K1's list report on the card, for one slot whose keys fall in lane
    order: the tables are exact, and the lanes listed (the winner at
    least) are counted apart from the entries the warps reserved."""
    _need_gpu()
    n = 1 << 14
    args = [torch.zeros(n, dtype=torch.int32, device="cuda"),
            torch.arange(n, 0, -1, device="cuda").float(),
            torch.arange(n, dtype=torch.int32, device="cuda"),
            torch.arange(n, dtype=torch.int32, device="cuda"), None,
            torch.ones(n, dtype=torch.bool, device="cuda")]
    args[4] = args[3]
    got, use = owner_scatter_min_list_use(*args, 4)
    exp = owner_scatter_min_ref(*args, 4)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert use.reserved % K1_CHUNK == 0 and use.reserved <= use.capacity
    assert 1 <= use.listed <= use.reserved


@pytest.mark.cuda
@pytest.mark.parametrize("m,block,offset", [(10007, 3, 0), (10007, 516, 0),
                                            (5000, 512, 1), (6000, 2048, 0)])
def test_cuda_k3_paths_match_plain(m, block, offset):
    _need_gpu()
    from repro_torch.kernels.segmin.segmin import segmin_candidates
    rng = np.random.default_rng(m + block)
    args = [torch.from_numpy(a).cuda()[offset:]
            for a in _runs(rng, m + offset, m // 20, tie_heavy=True)]
    got = segmin_candidates(*args, block=block)
    exp = segmin_candidates_ref(*args, min(block, max(m, 8)))
    torch.cuda.synchronize()
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["boruvka", "filter_boruvka"])
def test_cuda_lever_path_matches_plain(algorithm):
    """The sharded engine with every lever but the ghost cache, through
    K1 on the card at both MINEDGES sites (one launch each a round),
    equals its plain path in every output and ``round_trace`` row."""
    _need_gpu()
    from repro_torch.core.distributed import build_dist_graph
    from repro_torch.core.distributed_sharded import distributed_sharded_msf
    from repro_torch.kernels.segmin.segmin import owner_scatter_min
    from tests.helpers.graph_families import FAMILIES
    u, v, w, n = FAMILIES["dup_weights"](0)
    g, _ = build_dist_graph(u, v, w, n, 8, device="cuda")
    runs = []
    for pallas in (True, False):
        trace = []
        before = owner_scatter_min.launches
        res = distributed_sharded_msf(g, n, 8, algorithm=algorithm,
                                      ghost_cache=False,
                                      pallas_minedges=pallas,
                                      round_trace=trace)
        runs.append((res, trace, owner_scatter_min.launches - before))
    (kern, ktrace, klaunch), (plain, ptrace, plaunch) = runs
    assert klaunch == 2 * len(ktrace) > 0 and plaunch == 0
    assert ktrace == ptrace
    for a, b in zip(tuple(kern[:5]) + tuple(kern[5]),
                    tuple(plain[:5]) + tuple(plain[5])):
        assert torch.equal(a, b)
