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
// per grid step because a TPU has no scatter atomics; Hopper has them,
// so the kernel is three streaming passes plus an init and a decode:
//   1. every ok lane packs (w, eid) into one uint64 key -- an
//      order-preserving uint32 of w in the high half (-0.0 folded onto
//      +0.0, since the reference's compare treats them as equal), eid
//      with its sign bit flipped in the low half -- and does one 64-bit
//      atomicMin on its slot's key, so the lexicographic order is one
//      integer compare;
//   2. every ok lane whose key equals its slot's final key does an
//      atomicMax of each payload (initialised to -1);
//   3. each slot's key is decoded back to (wmin, emin).
// One launch covers all rows: blockIdx.y walks the rows, and lane j of
// row r updates slot r * size + idx[r * L + j].
//
// Bound.  Device-memory bytes: the ok byte of every lane, 12 B (idx, w,
// eid) of every ok lane, 8 B (pay1, pay2) only of the lanes that tie
// their slot's minimum -- pass 2 loads the payloads nowhere else -- and
// 16 B written per slot.  On the engine's capacity-padded exchange
// buffers most lanes are not ok and cost only their ok byte.  The second
// limit is atomic contention on hot slots (a giant component late in a
// solve collects most candidates): pass 1 reads the slot's current key
// first and skips the atomic when it cannot lower it, so a hot slot sees
// atomics only from lanes that improve on what they read.  A key only
// decreases, so a stale read can cost an extra atomic but never skip a
// needed one.
//
// NaN weights in ok lanes are outside the contract (alive implies finite
// on the engine path).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmptyKey = ~0ull;
constexpr int kEidSentinel = 1 << 30;
constexpr int kThreads = 256;

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

__global__ void init_tables(unsigned long long* keys, int* p1, int* p2,
                            long long slots) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < slots; s += stride) {
    keys[s] = kEmptyKey;
    p1[s] = -1;
    p2[s] = -1;
  }
}

// Candidate passes: blockIdx.y walks the rows, x the lanes of a row, so
// a lane's slot is row * size + idx with no division.
__global__ void min_keys(const int* idx, const float* w, const int* eid,
                         const unsigned char* ok, unsigned long long* keys,
                         long long rows, long long L, long long size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long lane0 = r * L;
    for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         j < L; j += stride) {
      const long long i = lane0 + j;
      if (!ok[i]) continue;
      const int s = idx[i];
      if (s < 0 || s >= size) continue;
      const long long slot = r * size + s;
      const unsigned long long key = pack(w[i], eid[i]);
      if (key < keys[slot]) atomicMin(&keys[slot], key);
    }
  }
}

__global__ void max_payloads(const int* idx, const float* w, const int* eid,
                             const int* pay1, const int* pay2,
                             const unsigned char* ok,
                             const unsigned long long* keys, int* p1,
                             int* p2, long long rows, long long L,
                             long long size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long lane0 = r * L;
    for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         j < L; j += stride) {
      const long long i = lane0 + j;
      if (!ok[i]) continue;
      const int s = idx[i];
      if (s < 0 || s >= size) continue;
      const long long slot = r * size + s;
      if (pack(w[i], eid[i]) != keys[slot]) continue;
      atomicMax(&p1[slot], pay1[i]);
      atomicMax(&p2[slot], pay2[i]);
    }
  }
}

__global__ void decode_keys(const unsigned long long* keys, float* wmin,
                            int* emin, long long slots) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < slots; s += stride) {
    const unsigned long long key = keys[s];
    if (key == kEmptyKey) {
      wmin[s] = __uint_as_float(0x7f800000u);  // +inf
      emin[s] = kEidSentinel;
    } else {
      wmin[s] = from_order_bits(static_cast<unsigned int>(key >> 32));
      emin[s] = static_cast<int>(static_cast<unsigned int>(key) ^
                                 0x80000000u);
    }
  }
}

// grid-stride loops: enough blocks to fill 132 SMs several times over
constexpr long long kMaxBlocks = 132LL * 16;

unsigned int blocks_for(long long n, long long per_block_cap = kMaxBlocks) {
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = per_block_cap < 1 ? 1 : per_block_cap;
  return static_cast<unsigned int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// rows * L candidate lanes, rows * size slots; every pointer is a device
// pointer to a contiguous buffer of that length.  `keys` is uint64
// scratch of rows * size.  Returns the cudaError_t of the launches.
extern "C" int owner_scatter_min_launch(
    const int* idx, const float* w, const int* eid, const int* pay1,
    const int* pay2, const unsigned char* ok, unsigned long long* keys,
    float* wmin, int* emin, int* p1, int* p2, long long rows, long long L,
    long long size, cudaStream_t stream) {
  const long long slots = rows * size;
  const unsigned int gy =
      static_cast<unsigned int>(rows < 65535 ? rows : 65535);
  const dim3 lane_grid(blocks_for(L, kMaxBlocks / gy), gy);
  init_tables<<<blocks_for(slots), kThreads, 0, stream>>>(keys, p1, p2,
                                                          slots);
  min_keys<<<lane_grid, kThreads, 0, stream>>>(idx, w, eid, ok, keys, rows,
                                               L, size);
  max_payloads<<<lane_grid, kThreads, 0, stream>>>(
      idx, w, eid, pay1, pay2, ok, keys, p1, p2, rows, L, size);
  decode_keys<<<blocks_for(slots), kThreads, 0, stream>>>(keys, wmin, emin,
                                                          slots);
  return static_cast<int>(cudaGetLastError());
}
