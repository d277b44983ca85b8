"""Host-side launch planning for the K1 and K3 CUDA kernels.

Pure functions of shapes, pointers and the card's SM count, so the CPU
tests can check them without a card:

* ``k1_plan`` — ``owner_scatter_min``: the wide 16-lane path or the
  scalar one, the grid, whether the two payloads alias, and the
  capacity of the list of payload candidates;
* ``k3_plan`` — ``segmin_candidates``: how many whole blocks one CTA
  covers (its span) and the vector or scalar path.

The constants below are the kernels' only definition of them:
``kernels/_build.py`` compiles each ``.cu`` file with the ``-D`` flags of
``CUDA_CONSTANTS``, and a source built without them does not compile.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

# --- K1 owner_scatter_min -------------------------------------------------
K1_THREADS = 256
K1_GROUP = 16        # lanes per thread per step: one uint4 of ok bytes
K1_CTAS_PER_SM = 8   # grid-stride CTAs launched per SM
K1_CHUNK = 128       # list entries a warp reserves at a time
K1_ENTRY_BYTES = 16  # one list entry: key (8 B), slot (4 B), lane (4 B)
_U32 = 1 << 32

# --- K3 segmin_candidates -------------------------------------------------
K3_E = 4             # consecutive elements per thread
K3_THREADS = 128
K3_TILE = K3_E * K3_THREADS  # elements a CTA holds at once

# kernel -> the constants its source takes as -D flags
CUDA_CONSTANTS = {
    "owner_scatter_min": {"K1_THREADS": K1_THREADS, "K1_GROUP": K1_GROUP,
                          "K1_CHUNK": K1_CHUNK,
                          "K1_ENTRY_BYTES": K1_ENTRY_BYTES},
    "segmin_candidates": {"K3_E": K3_E, "K3_THREADS": K3_THREADS},
}


class K1Plan(NamedTuple):
    vec: bool        # rows of whole 16-lane groups on 16-byte pointers
    alias: bool      # pay1 and pay2 are one buffer: load and update one
    grid: Tuple[int, int]  # (x: CTAs along a row, y: rows in parallel)
    threads: int
    capacity: int    # list entries; 0 = no list, a full resolve pass


def k1_list_capacity(rows: int, L: int, size: int, ctas: int) -> int:
    """Entries of K1's list of payload candidates.

    A lane is listed when its key is at most the slot key it observed,
    so in arrival order a slot lists about H(n) of its n lanes (a
    record each time the minimum drops, plus exact ties).  Sized for
    ``ln(lanes per slot) + 2`` per slot, plus the warps' part-used
    reservations; a run that lists more overflows, and the kernel then
    resolves the payloads with a full pass.  0 where a slot or lane
    index would not fit the entry's 32 bits.
    """
    slots, lanes = rows * size, rows * L
    if slots == 0 or lanes == 0 or slots >= _U32 - 1 or lanes >= _U32:
        return 0
    per_slot = math.ceil(math.log(max(lanes / slots, 1.0))) + 2
    waste = ctas * (K1_THREADS // 32) * K1_CHUNK
    return min(slots * per_slot, lanes) + waste


def k1_plan(rows: int, L: int, size: int, ptrs: Sequence[int],
            alias: bool, sms: int) -> K1Plan:
    """Launch plan of K1 for ``rows`` rows of ``L`` lanes into ``size``
    slots a row.  ``ptrs`` are the addresses of idx, w, eid and ok: the
    16-lane path needs each 16-byte aligned and ``L % 16 == 0``, so no
    group straddles two rows; any other input takes the scalar path."""
    vec = L % K1_GROUP == 0 and all(p % 16 == 0 for p in ptrs)
    units = L // K1_GROUP if vec else L
    gy = max(1, min(rows, 65535))
    want = max(1, -(-rows * units // K1_THREADS))
    ctas = min(want, sms * K1_CTAS_PER_SM)
    gx = max(1, -(-ctas // gy))
    cap = k1_list_capacity(rows, L, size, gx * gy)
    return K1Plan(vec, alias, (gx, gy), K1_THREADS, cap)


# --- K3 -------------------------------------------------------------------

class K3Plan(NamedTuple):
    span: int        # elements one CTA covers: whole blocks, or one block
    ctas: int
    vec: bool        # 16-byte loads and stores where a chunk is whole


def k3_plan(m: int, block: int, ptrs: Sequence[int]) -> K3Plan:
    """Launch plan of K3 for ``m`` elements in blocks of ``block``.

    A block of at most one tile shares its CTA with as many whole
    blocks as fit (a count rounded so that the span is a multiple of
    ``K3_E``, where that leaves at least one); a larger block has a CTA
    of its own, which walks it tile by tile.  ``ptrs`` are seg, w, eid
    (16-byte loads), alive (4-byte loads) and the two outputs: the
    vector path needs them aligned and a span that keeps every chunk on
    a multiple of ``K3_E``."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if block <= K3_TILE:
        per = K3_TILE // block
        step = K3_E // math.gcd(block, K3_E)
        if per >= step:
            per -= per % step
        span = per * block
    else:
        span = block
    aligned = (all(p % 16 == 0 for i, p in enumerate(ptrs) if i != 3)
               and (len(ptrs) < 4 or ptrs[3] % 4 == 0))
    return K3Plan(span, max(1, -(-m // span)),
                  aligned and span % K3_E == 0)
