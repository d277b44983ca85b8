"""Round-level checkpoints for the sharded MSF engine.

Port of ``repro/core/msf_checkpoint.py``, kept as this package's own
numpy copy with the same field layout and CRC32s, so a checkpoint taken
by either package resumes in the other.  At the paper's scale a component
failure mid-run is the expected case; re-executing from round 0 is the
costly recovery.  Borůvka's per-round state is exactly the O(n/p)
vertex-keyed tables, so a snapshot between rounds is one label vector,
three masks and the chosen-edge ids — not the edge arrays, which the
host already holds.

An ``MSFCheckpoint`` is a plain host-side value (numpy only, like
``core/plan.py``):

  * vertex-keyed state: the contracted label table ``lab`` and the
    per-level ``settled`` mask, both laid out ``[p * vps]`` and indexed
    by vertex id (shard-major layout makes the flat index *be* the
    vid), which is what makes **elastic restore** a re-owner-mapping:
    a p′-shard mesh re-slices the same first ``n`` entries;
  * edge-keyed state: the slot-aligned MSF ``mask`` and dead-edge mask
    for bit-exact same-mesh resume, plus the mesh-independent ``eids``
    of the chosen undirected edges — the representation that survives
    re-partitioning the edges from the host store onto p′ shards
    (``remap``: mask slots are re-derived as the canonical ``u < v``
    copy per chosen eid, dead as label-internal edges);
  * position: executed-round count, the (level, in-level round) the
    host driver re-enters at, the plan-round index ``plan_pos`` the
    unrolled executor skips ahead to, and the frozen level weight
    windows (recomputing pivots on a p′ mesh could move them);
  * integrity: a per-shard CRC32 over that shard's slices of every
    array, re-checked on restore (``verify_checksums``) so a checkpoint
    corrupted at rest is a typed ``CheckpointError``, never a wrong
    resume.

Certification is the *taker's* job, not this module's: both drivers run
the ``core/verify.py`` invariant barrier (label fixpoint, range,
``count == n - components``, edge sanity) **before** constructing the
checkpoint, so every checkpoint in a ``ckpt_out`` list is
certified-good — resuming from one can never replay a corrupted state.
Ghost tables are deliberately *not* snapshotted: they are a cache of
the label table and are rebuilt on restore through the existing setup
path (``_ghost_setup``), which keeps the checkpoint O(n/p) and makes
elastic restore trivially coherent.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np


class CheckpointError(RuntimeError):
    """A checkpoint failed integrity or shape validation on restore."""


def _shard_crc(arrays, shard: int, spans) -> np.uint32:
    """CRC32 over ``shard``'s slice of every array (``spans[i]`` is the
    per-shard span of ``arrays[i]``)."""
    crc = 0
    for a, span in zip(arrays, spans):
        lo = shard * span
        sl = np.ascontiguousarray(a[lo:lo + span])
        crc = zlib.crc32(sl.tobytes(), crc)
    return np.uint32(crc)


@dataclasses.dataclass(frozen=True)
class MSFCheckpoint:
    """One certified snapshot of the sharded engine's per-round state.

    ``round_index`` counts rounds *executed* before the snapshot;
    ``level`` / ``round_in_level`` are the position the shrinking driver
    re-enters at; ``plan_pos`` is the index into ``RoundPlan.rounds``
    the unrolled executor skips ahead to (``None`` for driver-taken
    checkpoints, which have no plan).  ``stats_acc`` carries the
    driver's 8-field comm accumulator so a resumed run's ``CommStats``
    continues the interrupted run's totals.
    """
    n: int
    num_shards: int
    cap_per_shard: int
    algorithm: str
    round_index: int
    level: int
    round_in_level: int
    plan_pos: Optional[int]
    level_bounds: Tuple[Tuple[float, float], ...]
    lab: np.ndarray          # int32 [p * vps] — label table, vid-indexed
    settled: np.ndarray      # bool  [p * vps] — current level's mask
    mask: np.ndarray         # bool  [p * cap] — MSF slots chosen so far
    dead: np.ndarray         # bool  [p * cap] — retired edge slots
    eids: np.ndarray         # int32 sorted — chosen undirected edge ids
    ghost_on: bool           # ghost cache still active at the snapshot
    stats_acc: np.ndarray    # float64 [8] — driver comm accumulator
    checksums: np.ndarray    # uint32 [p] — per-shard content CRC32

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(n: int, num_shards: int, cap_per_shard: int,
               algorithm: str, round_index: int, level: int,
               round_in_level: int, plan_pos: Optional[int],
               level_bounds, lab, settled, mask, dead, eid,
               ghost_on: bool, stats_acc) -> "MSFCheckpoint":
        """Snapshot (copies taken; ``eid`` is the graph's slot-aligned
        edge-id column from which the chosen undirected ids are read)."""
        p = num_shards
        lab = np.array(lab, np.int32, copy=True)
        settled = np.array(settled, bool, copy=True)
        mask = np.array(mask, bool, copy=True)
        dead = np.array(dead, bool, copy=True)
        eids = np.unique(np.asarray(eid, np.int32)[mask])
        vps = lab.shape[0] // p
        cap = mask.shape[0] // p
        sums = np.array(
            [_shard_crc((lab, settled, mask, dead), s,
                        (vps, vps, cap, cap)) for s in range(p)],
            np.uint32)
        return MSFCheckpoint(
            n=n, num_shards=p, cap_per_shard=cap_per_shard,
            algorithm=algorithm, round_index=int(round_index),
            level=int(level), round_in_level=int(round_in_level),
            plan_pos=plan_pos,
            level_bounds=tuple((float(lo), float(hi))
                               for lo, hi in level_bounds),
            lab=lab, settled=settled, mask=mask, dead=dead, eids=eids,
            ghost_on=bool(ghost_on),
            stats_acc=np.array(stats_acc, np.float64, copy=True),
            checksums=sums)

    # -- integrity ---------------------------------------------------------

    def verify_checksums(self) -> "MSFCheckpoint":
        """Recompute every per-shard CRC and compare; raises the typed
        ``CheckpointError`` naming the corrupted shards on mismatch."""
        p = self.num_shards
        vps = self.lab.shape[0] // p
        cap = self.mask.shape[0] // p
        now = np.array(
            [_shard_crc((self.lab, self.settled, self.mask, self.dead),
                        s, (vps, vps, cap, cap)) for s in range(p)],
            np.uint32)
        bad = np.nonzero(now != self.checksums)[0]
        if bad.size:
            raise CheckpointError(
                f"checkpoint content checksum mismatch on shard(s) "
                f"{bad.tolist()} (round {self.round_index}): the "
                "snapshot was corrupted at rest — refusing to resume")
        return self

    def validate_for(self, n: int, num_shards: int,
                     cap_per_shard: int) -> "MSFCheckpoint":
        """Shape gate for same-mesh resume (checksums included)."""
        self.verify_checksums()
        if (self.n, self.num_shards, self.cap_per_shard) != \
                (n, num_shards, cap_per_shard):
            raise CheckpointError(
                f"checkpoint was taken at n={self.n}, "
                f"p={self.num_shards}, cap/shard={self.cap_per_shard} "
                f"but this solve has n={n}, p={num_shards}, "
                f"cap/shard={cap_per_shard}; use remap() + the host "
                "edge store for an elastic restore")
        return self

    # -- elastic restore ---------------------------------------------------

    def remap(self, num_shards: int, cap_per_shard: int,
              u: np.ndarray, v: np.ndarray,
              eid: np.ndarray) -> "MSFCheckpoint":
        """Re-key this checkpoint onto a p′-shard mesh (elastic restore).

        ``u`` / ``v`` / ``eid`` are the slot columns of the graph
        *re-partitioned from the host store* at the new shard count
        (``build_dist_graph(..., num_shards=p′)``).  Vertex-keyed state
        re-owner-maps (the flat layout is vid-indexed, so the first
        ``n`` entries transfer verbatim; the tail is identity labels /
        unsettled).  Edge-keyed state is re-derived: the MSF mask marks
        the canonical ``u < v`` copy of every chosen ``eid`` and the
        dead mask is exactly the label-internal edges — a superset of
        the original dead mask that retires the same information, since
        ``alive`` is recomputed as ``ru != rv`` every round anyway.
        The resumed position (level / round / plan_pos / stats) and the
        frozen level windows carry over unchanged.
        """
        self.verify_checksums()
        p2 = int(num_shards)
        vps2 = max(1, -(-self.n // p2))
        u = np.asarray(u)
        v = np.asarray(v)
        eid = np.asarray(eid, np.int32)
        if u.shape[0] != p2 * cap_per_shard:
            raise CheckpointError(
                f"re-partitioned edge arrays have {u.shape[0]} slots, "
                f"expected p'*cap = {p2 * cap_per_shard}")
        lab2 = np.arange(p2 * vps2, dtype=np.int32)
        lab2[:self.n] = self.lab[:self.n]
        settled2 = np.zeros(p2 * vps2, bool)
        settled2[:self.n] = self.settled[:self.n]
        chosen = np.zeros(int(eid.max(initial=0)) + 1, bool)
        chosen[self.eids] = True
        mask2 = chosen[eid] & (u < v)
        dead2 = lab2[np.minimum(u, p2 * vps2 - 1)] == \
            lab2[np.minimum(v, p2 * vps2 - 1)]
        return MSFCheckpoint.create(
            n=self.n, num_shards=p2, cap_per_shard=int(cap_per_shard),
            algorithm=self.algorithm, round_index=self.round_index,
            level=self.level, round_in_level=self.round_in_level,
            plan_pos=self.plan_pos, level_bounds=self.level_bounds,
            lab=lab2, settled=settled2, mask=mask2, dead=dead2,
            eid=eid, ghost_on=self.ghost_on, stats_acc=self.stats_acc)

    # -- introspection -----------------------------------------------------

    @property
    def mst_count(self) -> int:
        return int(self.eids.size)

    def __repr__(self) -> str:  # dataclass default would dump the arrays
        return (f"MSFCheckpoint(n={self.n}, p={self.num_shards}, "
                f"round={self.round_index}, level={self.level}.r"
                f"{self.round_in_level}, plan_pos={self.plan_pos}, "
                f"edges={self.mst_count}, ghost_on={self.ghost_on})")


def latest_certified(ckpts: List[MSFCheckpoint]
                     ) -> Optional[MSFCheckpoint]:
    """The most advanced checkpoint of a ``ckpt_out`` list (the drivers
    only append certified snapshots, so "last" is also "best")."""
    return ckpts[-1] if ckpts else None
