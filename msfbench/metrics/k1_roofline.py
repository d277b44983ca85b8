"""k1_roofline (layer: kernels): K1 (``owner_scatter_min``, both
MINEDGES sites of the sharded engine) against its memory roofline.

Each call on the card is timed by CUDA events recorded on its stream
around the wrapper, so its time holds every launch, memset and copy the
call makes.  The bytes are those its inputs need, counted the same
whatever implements K1: each lane's ``ok`` byte read once; ``idx``,
``w`` and ``eid`` (12 B) of each live lane (``ok``, ``idx`` in range);
the payloads of each winning lane (a live lane equal to its slot's
``(wmin, emin)``; 4 B where ``pay1`` and ``pay2`` are one buffer, else
8 B); and 16 B written per slot.  The share is the bytes at the H100's
3.35 TB/s over the calls' summed time.  The counts are taken on the
device after each call's end event, with no host sync.
"""
import torch

SITE = "repro_torch.kernels.segmin.ops:owner_scatter_min"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def bytes_needed(idx, w, eid, pay1, pay2, ok, size, wmin, emin):
    """The frozen byte count of one call (a 0-dim int64 tensor)."""
    L = idx.shape[-1]
    rows = idx.numel() // max(L, 1)
    idx, w, eid, ok = (t.reshape(rows, L) for t in (idx, w, eid, ok))
    row = torch.arange(rows, device=idx.device).view(-1, 1)
    live = ok & (idx >= 0) & (idx < size)
    slot = idx.long().clamp(0, max(size - 1, 0)) + row * size
    win = (live & (w == wmin.reshape(-1)[slot])
           & (eid == emin.reshape(-1)[slot]))
    pay = 4 if pay1.data_ptr() == pay2.data_ptr() else 8
    return (rows * L + 16 * rows * size
            + 12 * live.sum(dtype=torch.int64)
            + pay * win.sum(dtype=torch.int64))


def install(run):
    run.spans.replace(SITE, lambda k1: _timed(k1, run.counters))


def _timed(k1, counters):
    calls = counters.setdefault("k1", [])

    def timed(idx, w, eid, pay1, pay2, ok, size, *rest, **kw):
        if idx.device.type != "cuda":
            return k1(idx, w, eid, pay1, pay2, ok, size, *rest, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = k1(idx, w, eid, pay1, pay2, ok, size, *rest, **kw)
        end.record()
        calls.append((start, end, bytes_needed(idx, w, eid, pay1, pay2, ok,
                                               size, out[0], out[1])))
        return out
    return timed


def read(run):
    calls = run.counters.get("k1")
    if not calls:
        return None
    torch.cuda.synchronize()
    seconds = sum(s.elapsed_time(e) for s, e, _ in calls) / 1e3
    need = sum(int(b) for _, _, b in calls)
    if seconds <= 0:
        return None
    run.note(f"k1_roofline over {len(calls)} calls: {need} B in "
             f"{seconds:.6f} s")
    return 100.0 * (need / HBM_BYTES_PER_S) / seconds
