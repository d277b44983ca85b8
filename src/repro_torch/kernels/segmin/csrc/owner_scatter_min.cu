// K1: fused (w, eid)-lexicographic scatter-min with winner payloads, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/segmin/segmin.py: _scatter_min_kernel (called through
// owner_scatter_min), which the sharded engine's owner-side MINEDGES runs
// once per round (repro/core/distributed_sharded.py: _owner_scatter_min).
//
// What it computes, per row r (a stacked shard) and slot s in [0, size):
// over the lanes i of row r with ok[i] and idx[i] == s, the
// lexicographic minimum of (w[i], eid[i]), plus the max of pay1[i] and
// pay2[i] over the lanes that hit that exact minimum.  A slot with no
// lane holds (+inf, 2^30, -1, -1).  Lanes with ok == 0 never read idx;
// an ok lane with idx outside [0, size) is dropped, as the TPU kernel's
// one-hot match drops it.
//
// Design.  The TPU kernel builds a one-hot [out_block, block] hit matrix
// per grid step because a TPU has no scatter atomics; Hopper has them.
// (w, eid) packs into one uint64 key -- an order-preserving uint32 of w
// in the high half (-0.0 folded onto +0.0, since the reference's compare
// treats them as equal), eid with its sign bit flipped in the low half --
// so the lexicographic order is one integer compare.  Two passes:
//   1. min_pass: a thread holds 4 consecutive lanes at a time.  Lanes
//      side by side on one slot form a run (the engine's buffers hold
//      each vertex's candidates together); only the lanes at their run's
//      minimum can win, and only the run's first lane touches L2: it
//      reads the slot's key and, where the run's minimum is lower, does
//      one 64-bit atomicMin and takes its old value.  A slot's key only
//      decreases, so a lane above the value its run saw can never win;
//      the lanes at the run's minimum and at most that value go on a
//      compact list of (key, slot, lane).  In arrival order that is
//      about H(n) of a slot's n runs, plus runs that lose a race.  Warps
//      reserve list entries kChunk at a time with one atomicAdd, place
//      their lanes by ballot, and mark what they leave unused;
//   2. resolve_list decodes every slot's key to (wmin, emin) and walks
//      the list, kEntries entries a thread at once: an entry whose key
//      equals its slot's final key loads its payload and does an
//      atomicMax.  If the list overflowed (the counter passed its
//      capacity), resolve_all walks every ok lane instead, reading a
//      slot's payload first so that a hot slot sees atomics only from
//      lanes that raise it; otherwise it returns at once.
// When pay1 and pay2 are one buffer (both engine call sites pass the same
// tensor), the kernels load and update pay1 only, and the launch copies
// its table into pay2's.  The tables start from cudaMemsetAsync(0xFF):
// key ~0 (empty) and payload -1.
//
// Loads.  In the engine's exchange buffers the ok lanes are long
// prefixes of each [source, capacity] segment, 1 lane in 8 at full
// scale.  On the wide path (rows of whole 16-lane groups, 16-byte
// pointers) a warp walks tiles of 512 lanes: each thread reads the ok
// bytes of 16 lanes as one uint4, the next tile's while it works on this
// one, and a warp whose tile is all dead moves on without touching idx,
// w or eid.  Then batch b of thread t is lanes 128 b + 4 t, whose ok
// word comes by shuffle; an all-ok batch loads idx, w and eid as one
// 16-byte load each, so that every warp load is one coalesced 512-byte
// access, and a mixed batch loads lane by lane.  Any other input
// (L % 16 != 0, a pointer off 16 bytes) takes the scalar path of the same
// kernels: one lane per thread.  Planned on the host by
// kernels/segmin/plan.py: k1_plan.
//
// Bound.  Device-memory bytes: the ok byte of every lane, 12 B (idx, w,
// eid) of every ok lane, 8 B (pay1, pay2) of each winning lane (4 B where
// the payloads are one buffer), 16 B written per slot; the list adds 32 B (written, read) per listed lane.
// Beside the bytes, L2: one 8-byte key read per run, an atomic only where
// a run lowers the key, so a hot slot sees atomics only from runs that
// improve on what they read.  A read may be stale; a key only decreases,
// so staleness can list an extra lane or add an atomic but never drop a
// lane that could win.  What the card shows (PERF.md): the streaming
// alone takes about 70% of the first pass, the L2 round trips of the
// live tiles most of the rest.
//
// NaN weights in ok lanes are outside the contract (alive implies finite
// on the engine path).

#include <cstdint>

#include <cuda_runtime.h>

// The launch constants are defined once, in kernels/segmin/plan.py
// (CUDA_CONSTANTS), and come in as -D flags from kernels/_build.py.
#if !defined(K1_THREADS) || !defined(K1_GROUP) || !defined(K1_CHUNK) || \
    !defined(K1_ENTRY_BYTES)
#error "build with -DK1_THREADS -DK1_GROUP -DK1_CHUNK -DK1_ENTRY_BYTES"
#endif

namespace {

constexpr unsigned long long kEmptyKey = ~0ull;
constexpr int kEidSentinel = 1 << 30;
constexpr unsigned int kFullMask = 0xffffffffu;
constexpr unsigned int kNoSlot = 0xffffffffu;  // an unused list entry
constexpr unsigned int kAllOk = 0x01010101u;   // four ok bytes
constexpr unsigned int kChunk = K1_CHUNK;  // list entries a warp reserves
constexpr int kThreads = K1_THREADS;
static_assert(K1_GROUP == sizeof(uint4), "a group is one uint4 of ok bytes");
static_assert(K1_ENTRY_BYTES == sizeof(uint4), "a list entry is one uint4");
static_assert(kThreads % 32 == 0, "whole warps");
constexpr int kBatch = 4;     // lanes a thread holds at once
constexpr int kEntries = 4;   // list entries a thread resolves at once

__device__ __forceinline__ unsigned int order_bits(float w) {
  unsigned int b = __float_as_uint(w);
  if (b == 0x80000000u) b = 0u;  // -0.0 ties +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ unsigned long long pack(float w, int eid) {
  return (static_cast<unsigned long long>(order_bits(w)) << 32) |
         static_cast<unsigned long long>(static_cast<unsigned int>(eid) ^
                                         0x80000000u);
}

struct Args {
  const int* idx;
  const float* w;
  const int* eid;
  const int* pay1;
  const int* pay2;
  const unsigned char* ok;
  unsigned long long* keys;
  float* wmin;
  int* emin;
  int* p1;
  int* p2;
  uint4* list;                  // {key lo, key hi, slot, lane}
  unsigned long long* counter;  // list entries reserved
  unsigned long long cap;       // list entries; 0 = no list
  long long rows, L, size;
  int vec, alias;
};

// A warp's reservation in the list: entries [next, next + left).
struct Reservation {
  unsigned long long next;
  unsigned int left;
};

// Warp-uniform: every lane calls it, each with its own `listed`.
__device__ __forceinline__ void append(const Args& a, Reservation& res,
                                       bool listed, unsigned long long key,
                                       unsigned int slot, unsigned int lane,
                                       int warp_lane) {
  const unsigned int mask = __ballot_sync(kFullMask, listed);
  if (mask == 0u) return;
  const unsigned int n = __popc(mask);
  const unsigned int rank = __popc(mask & ((1u << warp_lane) - 1u));
  unsigned long long fresh = 0;
  if (n > res.left) {
    if (warp_lane == 0) fresh = atomicAdd(a.counter, 1ull * kChunk);
    fresh = __shfl_sync(kFullMask, fresh, 0);
  }
  if (listed) {
    const unsigned long long pos =
        rank < res.left ? res.next + rank : fresh + (rank - res.left);
    if (pos < a.cap) {
      a.list[pos] = make_uint4(static_cast<unsigned int>(key),
                               static_cast<unsigned int>(key >> 32), slot,
                               lane);
    }
  }
  if (n > res.left) {
    res.next = fresh + (n - res.left);
    res.left = kChunk - (n - res.left);
  } else {
    res.next += n;
    res.left -= n;
  }
}

// Marks the unused rest of a warp's reservation.
__device__ __forceinline__ void release(const Args& a,
                                        const Reservation& res,
                                        int warp_lane) {
  for (unsigned int u = warp_lane; u < res.left; u += 32) {
    if (res.next + u < a.cap) {
      a.list[res.next + u] = make_uint4(0u, 0u, kNoSlot, 0u);
    }
  }
}

// Up to kBatch lanes of one row, as a thread holds them at once.
struct Lanes {
  unsigned long long key[kBatch];
  int slot[kBatch];   // idx, in [0, size) where live
  unsigned int live;  // bit j: lane j is ok with idx in range
};

// Pass 1 on a thread's lanes.  Consecutive live lanes on one slot form
// a run (the engine's buffers hold each vertex's candidates side by
// side); only the lanes at their run's minimum can win, and only the
// run's first lane touches L2: it reads the slot's key and, where the
// run's minimum is lower, does an atomicMin and takes its old value.
// The lanes at the run's minimum that are at most that value are
// listed.  Warp-uniform (append).
__device__ __forceinline__ void min_lanes(const Args& a, Reservation& res,
                                          const Lanes& ln, long long row,
                                          long long lane0, int count,
                                          int warp_lane) {
  unsigned long long* row_keys = a.keys + row * a.size;
  const unsigned int live = ln.live & ((1u << count) - 1u);
  unsigned int joins = 0u;  // bit j: lane j continues lane j - 1's run
  unsigned long long best[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j >= count) break;
    const bool join = j > 0 && (live >> j & 1u) && (live >> (j - 1) & 1u) &&
                      ln.slot[j] == ln.slot[j - 1];
    joins |= static_cast<unsigned int>(join) << j;
    best[j] = join ? (ln.key[j] < best[j - 1] ? ln.key[j] : best[j - 1])
                   : ln.key[j];
  }
#pragma unroll
  for (int j = kBatch - 2; j >= 0; --j) {
    if (j + 1 < count && (joins >> (j + 1) & 1u)) best[j] = best[j + 1];
  }
  const unsigned int leads = live & ~joins;
  unsigned long long seen[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    seen[j] = (leads >> j & 1u) ? __ldcg(row_keys + ln.slot[j]) : 0ull;
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if ((leads >> j & 1u) && best[j] < seen[j]) {
      seen[j] = atomicMin(row_keys + ln.slot[j], best[j]);
    }
  }
  if (a.cap == 0) return;
  unsigned int listed = 0u;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j >= count) break;
    if (j > 0 && (joins >> j & 1u)) seen[j] = seen[j - 1];
    if ((live >> j & 1u) && ln.key[j] == best[j] && ln.key[j] <= seen[j]) {
      listed |= 1u << j;
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j >= count) break;
    append(a, res, listed >> j & 1u, ln.key[j],
           static_cast<unsigned int>(row * a.size + ln.slot[j]),
           static_cast<unsigned int>(lane0 + j), warp_lane);
  }
}

// The full payload pass on a thread's lanes: a lane whose key is its
// slot's final key raises the slot's payloads, reading them first so
// that a hot slot sees atomics only from lanes that raise it.
__device__ __forceinline__ void resolve_lanes(const Args& a, const Lanes& ln,
                                              long long row, long long lane0,
                                              int count) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j >= count || !(ln.live >> j & 1u)) continue;
    const long long slot = row * a.size + ln.slot[j];
    if (ln.key[j] != __ldg(a.keys + slot)) continue;
    const int v1 = __ldg(a.pay1 + lane0 + j);
    if (v1 > __ldcg(a.p1 + slot)) atomicMax(a.p1 + slot, v1);
    if (!a.alias) {
      const int v2 = __ldg(a.pay2 + lane0 + j);
      if (v2 > __ldcg(a.p2 + slot)) atomicMax(a.p2 + slot, v2);
    }
  }
}

// One lane through the scalar path.
__device__ __forceinline__ void load_lane(const Args& a, Lanes& ln, int j,
                                          long long i) {
  const int s = __ldg(a.idx + i);
  if (s >= 0 && s < a.size) {
    ln.live |= 1u << j;
    ln.slot[j] = s;
    ln.key[j] = pack(__ldg(a.w + i), __ldg(a.eid + i));
  }
}

// Four lanes from their ok word: all ok as one 16-byte load per array,
// mixed lane by lane.
__device__ __forceinline__ void load_batch(const Args& a, Lanes& ln,
                                           unsigned int word, long long i0) {
  ln.live = 0u;
  if (word == 0u) return;
  if (word == kAllOk) {
    const int4 s = __ldcs(reinterpret_cast<const int4*>(a.idx + i0));
    const float4 w = __ldcs(reinterpret_cast<const float4*>(a.w + i0));
    const int4 e = __ldcs(reinterpret_cast<const int4*>(a.eid + i0));
    const int sv[4] = {s.x, s.y, s.z, s.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const int ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (sv[j] >= 0 && sv[j] < a.size) {
        ln.live |= 1u << j;
        ln.slot[j] = sv[j];
        ln.key[j] = pack(wv[j], ev[j]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((word >> (8 * j)) & 0xffu) load_lane(a, ln, j, i0 + j);
  }
}

// Walks every lane of every row once, `Pass1` choosing the pass.  The
// loop trip counts are warp-uniform, as append needs.
template <bool Pass1>
__device__ __forceinline__ void walk_lanes(const Args& a,
                                           Reservation& res) {
  const int warp_lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
  const long long first_warp = first >> 5;
  const long long warps = stride >> 5;
  Lanes ln;
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    const long long row0 = r * a.L;
    if (a.vec) {
      // A warp walks tiles of 512 lanes.  Each thread reads the ok bytes
      // of 16 lanes as one uint4 (the next tile's while it works on
      // this one), then takes 4 batches of 4 lanes, batch b of thread t
      // being lanes 128 b + 4 t, whose ok word comes by shuffle: every
      // load of idx, w and eid is one coalesced 512-byte warp access.
      const long long groups = a.L >> 4;
      const long long tiles = (groups + 31) >> 5;
      const uint4* okv = reinterpret_cast<const uint4*>(a.ok + row0);
      const uint4 none = make_uint4(0u, 0u, 0u, 0u);
      long long g = (first_warp << 5) + warp_lane;
      uint4 o = g < groups ? __ldcs(okv + g) : none;
      for (long long tile = first_warp; tile < tiles; tile += warps) {
        g += warps << 5;
        const uint4 next = g < groups ? __ldcs(okv + g) : none;
        if (__any_sync(kFullMask, (o.x | o.y | o.z | o.w) != 0u)) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int src = 8 * b + (warp_lane >> 2);
            const unsigned int x = __shfl_sync(kFullMask, o.x, src);
            const unsigned int y = __shfl_sync(kFullMask, o.y, src);
            const unsigned int z = __shfl_sync(kFullMask, o.z, src);
            const unsigned int w = __shfl_sync(kFullMask, o.w, src);
            const int c = warp_lane & 3;
            const unsigned int word = c < 2 ? (c ? y : x) : (c == 2 ? z : w);
            const long long lane0 =
                row0 + (tile << 9) + 128 * b + 4 * warp_lane;
            load_batch(a, ln, word, lane0);
            if constexpr (Pass1) {
              min_lanes(a, res, ln, r, lane0, kBatch, warp_lane);
            } else {
              resolve_lanes(a, ln, r, lane0, kBatch);
            }
          }
        }
        o = next;
      }
    } else {
      for (long long jb = first; jb < a.L; jb += stride) {
        const long long j = jb + warp_lane;
        ln.live = 0u;
        if (j < a.L && a.ok[row0 + j]) load_lane(a, ln, 0, row0 + j);
        if constexpr (Pass1) {
          min_lanes(a, res, ln, r, row0 + j, 1, warp_lane);
        } else {
          resolve_lanes(a, ln, r, row0 + j, 1);
        }
      }
    }
  }
}

__device__ __forceinline__ bool list_overflowed(const Args& a) {
  return a.cap == 0 || *a.counter > a.cap;
}

__global__ void __launch_bounds__(kThreads) min_pass(Args a) {
  Reservation res{0ull, 0u};
  walk_lanes<true>(a, res);
  if (a.cap) release(a, res, threadIdx.x & 31);
}

// Decodes every slot's key; unless the list overflowed, raises the
// payloads of its entries whose key is their slot's final key,
// kEntries entries a thread at once: their slot keys, then the
// winners' payloads, in flight together.
__global__ void __launch_bounds__(kThreads) resolve_list(Args a) {
  const long long tid =
      (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
          blockDim.x + threadIdx.x;
  const long long stride =
      static_cast<long long>(gridDim.x) * gridDim.y * blockDim.x;
  const long long slots = a.rows * a.size;
  for (long long s = tid; s < slots; s += stride) {
    const unsigned long long key = __ldg(a.keys + s);
    if (key == kEmptyKey) {
      a.wmin[s] = __uint_as_float(0x7f800000u);  // +inf
      a.emin[s] = kEidSentinel;
    } else {
      a.wmin[s] = from_order_bits(static_cast<unsigned int>(key >> 32));
      a.emin[s] = static_cast<int>(static_cast<unsigned int>(key) ^
                                   0x80000000u);
    }
  }
  if (list_overflowed(a)) return;
  const long long listed = static_cast<long long>(*a.counter);
  for (long long e0 = tid; e0 < listed; e0 += kEntries * stride) {
    uint4 ent[kEntries];
    unsigned long long now[kEntries];
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      const long long e = e0 + k * stride;
      ent[k] = e < listed ? __ldcs(a.list + e)
                          : make_uint4(0u, 0u, kNoSlot, 0u);
    }
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      now[k] = ent[k].z != kNoSlot ? __ldg(a.keys + ent[k].z) : 0ull;
    }
#pragma unroll
    for (int k = 0; k < kEntries; ++k) {
      const unsigned long long key =
          (static_cast<unsigned long long>(ent[k].y) << 32) | ent[k].x;
      if (ent[k].z == kNoSlot || key != now[k]) continue;
      atomicMax(a.p1 + ent[k].z, __ldg(a.pay1 + ent[k].w));
      if (!a.alias) atomicMax(a.p2 + ent[k].z, __ldg(a.pay2 + ent[k].w));
    }
  }
}

// Where the list overflowed, raises the payloads from every lane.
__global__ void __launch_bounds__(kThreads) resolve_all(Args a) {
  if (!list_overflowed(a)) return;
  Reservation none{0ull, 0u};
  walk_lanes<false>(a, none);
}

}  // namespace

// rows * L candidate lanes, rows * size slots; every pointer is a device
// pointer to a contiguous buffer of that length.  Scratch: `keys` uint64
// of rows * size, `list` of `cap` 16-byte entries (unused when cap is 0)
// and one uint64 `counter`.  `vec`, the grid, `cap` and `alias` come from
// kernels/segmin/plan.py: k1_plan.  Returns the cudaError_t of the
// launches.
extern "C" int owner_scatter_min_launch(
    const int* idx, const float* w, const int* eid, const int* pay1,
    const int* pay2, const unsigned char* ok, unsigned long long* keys,
    void* list, unsigned long long* counter, float* wmin, int* emin,
    int* p1, int* p2, long long rows, long long L, long long size,
    long long cap, long long grid_x, long long grid_y, long long vec,
    long long alias, cudaStream_t stream) {
  const long long slots = rows * size;
  Args a{idx,  w,    eid,  pay1, pay2, ok,
         keys, wmin, emin, p1,   p2,   static_cast<uint4*>(list),
         counter, static_cast<unsigned long long>(cap),
         rows, L, size, static_cast<int>(vec), static_cast<int>(alias)};
  cudaError_t err = cudaMemsetAsync(keys, 0xff, slots * sizeof(*keys),
                                    stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(p1, 0xff, slots * sizeof(int), stream);
  }
  if (err == cudaSuccess && !alias) {
    err = cudaMemsetAsync(p2, 0xff, slots * sizeof(int), stream);
  }
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(counter, 0, sizeof(*counter), stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(grid_x),
                  static_cast<unsigned int>(grid_y));
  min_pass<<<grid, kThreads, 0, stream>>>(a);
  resolve_list<<<grid, kThreads, 0, stream>>>(a);
  resolve_all<<<grid, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess && alias) {
    err = cudaMemcpyAsync(p2, p1, slots * sizeof(int),
                          cudaMemcpyDeviceToDevice, stream);
  }
  return static_cast<int>(err);
}
