"""Deterministic fault injection for the capacity-bounded exchanges.

Port of ``repro/comm/faults.py``.  A ``FaultPlan`` is a seeded,
reproducible set of faults; while one is active (``inject``), the
exchange primitives of ``comm/exchange.py`` apply the specs whose
``site`` matches their call's label and book every affected item into
``ExchangeStats.injected``, so a chaos run (``launch/chaos.py``) can
assert that every injected fault is **detected** (overflow, a raised
replay error, a ``VerifyFailure``) or **tolerated** (a bit-identical
forest), never silent.

Fault kinds (``FaultSpec.kind``):

  * ``clip``         — the send-side admission test runs at
    ``max(1, int(capacity * cap_frac))`` while the buffers keep their
    shape, so the overflow counter fires as for an undersized capacity;
  * ``corrupt``      — a ``fraction`` of the valid items get bit ``bit``
    of every float32 payload leaf flipped;
  * ``shuffle_dest`` — selected items go to ``(dest + 1) % p``, or their
    subscriber bitmask rotates one shard left;
  * ``drop``         — delivered slots are cleared from ``recv_ok`` after
    the exchange; the sender still sees ``sent_ok`` and no overflow;
  * ``stall``        — shard ``shard`` contributes no item to the
    exchange (cleared before the overflow count);
  * ``abort``        — the exchange raises ``ShardAbort`` at a matched
    site on the selected ``rounds`` (empty: any round).  The host driver
    publishes its 1-based round through ``set_round``.

The reference applies its hooks when it traces a program; the port runs
eagerly, so it applies them when a primitive is called.  The effect is
the same: the hooks read the active plan and the published round at the
moment the exchange happens.

Selection is a pure integer hash of (seed, site, salt, the item's flat
index within its shard, the shard index), computed in int64 and masked
to 32 bits after every multiply and xor, so it equals the reference's
uint32 hash bit for bit and a chaos cell reproduces across runs.

The reference clears its compiled-program caches whenever a plan
activates or a round is published under an abort spec, so its programs
retrace through the hooks.  The port compiles nothing, so it has no such
registry.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch

FAULT_KINDS = ("clip", "corrupt", "shuffle_dest", "drop", "stall",
               "abort")

# the labelled exchange call sites of the engine and the verifier's own
# exchange; FaultPlan.validate rejects anything else loudly — a typo'd
# site would otherwise inject nothing and "pass" chaos vacuously
KNOWN_SITES = ("", "minedges", "lookup", "contract", "relabel", "push",
               "ghost_push_row", "ghost_push_col",
               "prep", "fill", "subscribe", "verify")

_U32 = 0xFFFFFFFF


class ShardAbort(RuntimeError):
    """A simulated shard death (``kind="abort"``), raised from a labelled
    exchange site.  Carries the matched ``site``, the host driver's
    ``round`` at the raise and the spec's ``shard``."""

    def __init__(self, site: str, round_: int, shard: int):
        self.site = site
        self.round = round_
        self.shard = shard
        super().__init__(
            f"shard {shard} aborted at site {site!r} in round {round_} "
            "(injected shard death)")


class FaultSpec(NamedTuple):
    """One injectable fault.  ``site`` targets a labelled exchange call
    site; the empty default matches every site except ``"verify"``, so
    the verifier stays trustworthy under a blanket plan."""
    kind: str
    site: str = ""            # "" = any engine site (never "verify")
    fraction: float = 1.0     # of valid items affected (corrupt/drop/
    #                           shuffle_dest); selection is hash-seeded
    cap_frac: float = 0.5     # clip: effective capacity multiplier
    bit: int = 12             # corrupt: float32 bit to XOR-flip
    shard: int = 0            # stall/abort: which shard dies/goes quiet
    rounds: Tuple[int, ...] = ()  # abort: fire on these driver rounds
    #                               (1-based; empty = any round)

    def matches(self, site: str) -> bool:
        if site == "verify":
            return self.site == "verify"
        return self.site in ("", site)


class FaultPlan(NamedTuple):
    """A seeded, deterministic set of faults to inject."""
    seed: int = 0
    specs: Tuple[FaultSpec, ...] = ()

    def validate(self) -> "FaultPlan":
        for s in self.specs:
            if s.kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {s.kind!r}; one of {FAULT_KINDS}")
            if s.site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown exchange site {s.site!r}; one of "
                    f"{KNOWN_SITES} (a typo'd site would inject nothing "
                    "and pass chaos vacuously)")
            if not (0.0 <= s.fraction <= 1.0):
                raise ValueError(f"fraction={s.fraction} not in [0, 1]")
            if not (0.0 < s.cap_frac <= 1.0):
                raise ValueError(f"cap_frac={s.cap_frac} not in (0, 1]")
            if not (0 <= s.bit < 32):
                raise ValueError(f"bit={s.bit} not a float32 bit")
            if any((not isinstance(r, int)) or r < 1 for r in s.rounds):
                raise ValueError(
                    f"rounds={s.rounds!r} must be 1-based round ints")
        return self


_ACTIVE: Optional[FaultPlan] = None
_ROUND: int = 0    # host drivers' published round counter (set_round)


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def set_round(r: int) -> None:
    """Publish the host driver's current (1-based, about-to-execute)
    round, which round-selected aborts read."""
    global _ROUND
    _ROUND = int(r)


def current_round() -> int:
    return _ROUND


def _maybe_abort(specs: Tuple[FaultSpec, ...], site: str) -> None:
    """The shard-death hook shared by every apply_* entry."""
    for s in specs:
        if s.kind == "abort" and (not s.rounds or _ROUND in s.rounds):
            raise ShardAbort(site, _ROUND, s.shard)


def specs_for(site: str) -> Tuple[FaultSpec, ...]:
    """The active plan's specs matching ``site`` (empty when inactive:
    the exchange primitives then run their fault-free code)."""
    if _ACTIVE is None:
        return ()
    return tuple(s for s in _ACTIVE.specs if s.matches(site))


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block.  The round
    counter starts at 0; on exit the plan is cleared, so later runs are
    fault-free.  Not reentrant: nested injection would make attribution
    ambiguous."""
    global _ACTIVE, _ROUND
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already active (not reentrant)")
    plan.validate()
    _ROUND = 0
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


# --------------------------------------------------------------------------
# application (called from comm/exchange.py) on stacked [p, ...] shards
# --------------------------------------------------------------------------

def _site_hash(site: str) -> int:
    h = 0
    for c in site:
        h = (h * 131 + ord(c)) & 0x7FFFFFFF
    return h


def _select(seed: int, site: str, salt: int, shape, fraction: float,
            device: torch.device) -> torch.Tensor:
    """Deterministic per-item selection mask of stacked ``shape`` (``[p,
    ...]``, shard s in row s): the reference's uint32 hash of (seed,
    site, salt, flat index within the shard, shard index)."""
    shape = tuple(int(d) for d in shape)
    p, per = shape[0], math.prod(shape[1:])
    idx = torch.arange(per, dtype=torch.int64, device=device).view(1, per)
    h = (idx * 2654435761) & _U32
    h = h ^ ((seed * 1000003 + _site_hash(site) + salt * 9176) & _U32)
    shard = torch.arange(p, dtype=torch.int64, device=device).view(p, 1)
    h = h ^ ((shard * 0x9E3779B9) & _U32)
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _U32
    h = h ^ (h >> 16)
    keep = min(10_000, int(round(fraction * 10_000)))
    return ((h % 10_000) < keep).view(shape)


def _flip_bit(x: torch.Tensor, sel: torch.Tensor, bit: int) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    mask = (1 << bit) - (1 << 32 if bit == 31 else 0)  # as an int32
    flipped = (x.view(torch.int32) ^ mask).view(torch.float32)
    return torch.where(sel, flipped, x)


def count(sel: torch.Tensor) -> torch.Tensor:
    """float32 ``[p]`` count of the set entries of each shard."""
    return sel.reshape(sel.shape[0], -1).sum(1).to(torch.float32)


def _map_leaves(payload, fn):
    if isinstance(payload, (tuple, list)):
        return tuple(fn(x) for x in payload)
    return fn(payload)


def _corrupt(payload, sel: torch.Tensor, bit: int):
    """Flip ``bit`` of the selected items of every float32 leaf that is
    one value an item (``[p, L]``; the reference's per-shard ``ndim ==
    1``)."""
    return _map_leaves(payload, lambda x: _flip_bit(x, sel, bit)
                       if x.dim() == 2 else x)


def _send_faults(specs, seed, site, payload, dest, valid, capacity, rotate):
    """The send-side kinds shared by both entries; ``rotate`` reroutes
    the selected items' destinations."""
    _maybe_abort(specs, site)
    p = valid.shape[0]
    dev = valid.device
    inj = torch.zeros(p, dtype=torch.float32, device=dev)
    cap_ok = capacity
    me = torch.arange(p, device=dev).view((p,) + (1,) * (valid.dim() - 1))
    for k, s in enumerate(specs):
        if s.kind == "stall":
            hit = valid & (me == s.shard)
            inj = inj + count(hit)
            valid = valid & ~hit
        elif s.kind == "clip":
            # the forced overflow is booked by the caller, which charges
            # the clipped rows to ``injected`` too
            cap_ok = min(cap_ok, max(1, int(capacity * s.cap_frac)))
        elif s.kind == "corrupt":
            sel = _select(seed, site, k, dest.shape, s.fraction, dev) & valid
            inj = inj + count(sel)
            payload = _corrupt(payload, sel, s.bit)
        elif s.kind == "shuffle_dest":
            sel = _select(seed, site, k, dest.shape, s.fraction, dev) & valid
            inj = inj + count(sel)
            dest = torch.where(sel, rotate(dest), dest)
    return payload, dest, valid, cap_ok, inj


def apply_send(specs: Tuple[FaultSpec, ...], seed: int, site: str,
               payload, dest: torch.Tensor, valid: torch.Tensor,
               capacity: int, p: int):
    """Send-side faults for ``routed_exchange`` over ``[p, L]`` items.
    Returns (payload, dest, valid, cap_ok, injected): ``cap_ok`` is the
    (possibly clipped) capacity the admission test uses — the buffers
    keep ``capacity`` — and ``injected`` the float32 ``[p]`` count of
    affected items, which the caller sums over shards."""
    return _send_faults(specs, seed, site, payload, dest, valid, capacity,
                        lambda d: (d + 1) % max(p, 1))


def apply_send_scatter(specs: Tuple[FaultSpec, ...], seed: int, site: str,
                       payload, dest_mask: torch.Tensor,
                       valid: torch.Tensor, capacity: int, p: int):
    """Send-side faults for the multicasts: ``dest_mask`` is a ``[p, L]``
    int32 bitmask over ``p`` destinations, which ``shuffle_dest`` rotates
    one destination left."""
    full = (1 << p) - 1

    def rotate(m):
        if p <= 1:
            return m
        return ((m << 1) | ((m >> (p - 1)) & 1)) & full

    return _send_faults(specs, seed, site, payload, dest_mask, valid,
                        capacity, rotate)


def apply_recv(specs: Tuple[FaultSpec, ...], seed: int, site: str,
               recv_ok: torch.Tensor):
    """Receive-side faults (``drop``): clear delivered slots of
    ``recv_ok`` (``[p, ...]``, each shard's receive buffers in the
    reference's layout) after the exchange.  The sender's ``sent_ok``
    and the overflow counter are untouched, so the loss is silent at the
    transport.  Returns (recv_ok, injected [p])."""
    _maybe_abort(specs, site)
    inj = torch.zeros(recv_ok.shape[0], dtype=torch.float32,
                      device=recv_ok.device)
    for k, s in enumerate(specs):
        if s.kind != "drop":
            continue
        sel = _select(seed, site, 101 + k, recv_ok.shape, s.fraction,
                      recv_ok.device) & recv_ok
        inj = inj + count(sel)
        recv_ok = recv_ok & ~sel
    return recv_ok, inj
