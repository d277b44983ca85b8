// K3: block-segmented run-end (w, eid)-min candidates, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/segmin/segmin.py: _segmin_kernel (called through
// segmin_candidates), phase 1 of the reference's min_edges_dense.
//
// What it computes.  The [m] arrays are cut into blocks of `block`
// elements (the last one ragged).  Within a block, a run is a contiguous
// stretch of equal seg.  At the last element of each run the kernel
// writes the run's lexicographic minimum of (w, eid) over its alive
// lanes, dead lanes counting as (+inf, 2^30); every other element gets
// (+inf, 2^30).  So a run that a block boundary cuts gives one candidate
// per piece, as in the TPU kernel.  An alive lane with w = +inf still
// competes on eid.  -0.0 ties +0.0 (a zero minimum comes out as +0.0).
// Unlike the TPU kernel's Hillis-Steele guard, which compares only the
// seg value at each distance, a run never takes in an earlier run of the
// same seg value: on unsorted seg the TPU kernel can over-include there.
// NaN weights in alive lanes are outside the contract.
//
// Design.  One CTA per block; a CTA of at most 1024 threads covers any
// block, each thread taking a contiguous chunk of ceil(block / 1024)
// elements (one element per thread for block <= 1024).  (w, eid) is
// folded into one order-preserving 64-bit key as in K1, so the
// lexicographic min is one integer min.
//   A. each thread scans its chunk once and keeps a carry: its first and
//      last seg, whether the chunk is one run, and the min key of its
//      trailing run;
//   B. an exclusive segmented scan of the carries across the CTA (warp
//      shuffles, then the 32 warp totals through shared memory) gives
//      each thread the min key of the run that is open where its chunk
//      starts;
//   C. each thread rescans its chunk from that carry and writes every
//      element's output.
// The TPU kernel runs log2(block) full-width vector steps; here each
// element is combined a constant number of times.
//
// Bound.  Device-memory bytes: seg, w, eid (12 B) and alive (1 B) read
// once and cand_w, cand_eid (8 B) written once, 21 B per element.  The
// reads of pass C and the look-ahead at the next element's seg hit L1:
// the CTA read the same few KB in pass A.  All loads and stores are
// coalesced for block <= 1024 (one element per thread).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kEidSentinel = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr unsigned int kFullMask = 0xffffffffu;

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

__device__ __forceinline__ unsigned long long lane_key(
    const float* __restrict__ w, const int* __restrict__ eid,
    const unsigned char* __restrict__ alive, long long i) {
  if (!alive[i]) return pack(__uint_as_float(0x7f800000u), kEidSentinel);
  return pack(w[i], eid[i]);
}

// The carry of a stretch of elements for the segmented min: its first
// and last seg, whether it is one run, and the min key of its trailing
// run (the maximal run at its end).
struct Carry {
  int first;
  int last;
  int uniform;
  unsigned long long key;
};

// `a` directly before `b`.  Associative: the segmented-scan operator.
__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b) {
  const bool joins = a.last == b.first;
  Carry r;
  r.first = a.first;
  r.last = b.last;
  r.uniform = a.uniform && b.uniform && joins;
  r.key = (b.uniform && joins) ? (a.key < b.key ? a.key : b.key) : b.key;
  return r;
}

__device__ __forceinline__ Carry shfl_up(const Carry& c, int d) {
  Carry r;
  r.first = __shfl_up_sync(kFullMask, c.first, d);
  r.last = __shfl_up_sync(kFullMask, c.last, d);
  r.uniform = __shfl_up_sync(kFullMask, c.uniform, d);
  r.key = __shfl_up_sync(kFullMask, c.key, d);
  return r;
}

// Inclusive scan within the warp; lanes past the data only feed lanes
// after them, which are past the data too.
__device__ __forceinline__ Carry warp_scan(Carry c, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const Carry up = shfl_up(c, d);
    if (lane >= d) c = combine(up, c);
  }
  return c;
}

__global__ void segmin_candidates_kernel(
    const int* __restrict__ seg, const float* __restrict__ w,
    const int* __restrict__ eid, const unsigned char* __restrict__ alive,
    float* __restrict__ cand_w, int* __restrict__ cand_e, long long m,
    long long block, long long chunk) {
  __shared__ Carry warp_total[kMaxThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const long long len = (m - base < block) ? (m - base) : block;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long first = t * chunk;
  const long long lo = base + (first < len ? first : len);
  const long long hi = base + (first + chunk < len ? first + chunk : len);

  // A: this chunk's carry
  Carry mine = {0, 0, 1, ~0ull};
  if (lo < hi) {
    int cur = seg[lo];
    unsigned long long key = lane_key(w, eid, alive, lo);
    mine.first = cur;
    for (long long i = lo + 1; i < hi; ++i) {
      const int s = seg[i];
      const unsigned long long k = lane_key(w, eid, alive, i);
      if (s == cur) {
        key = k < key ? k : key;
      } else {
        cur = s;
        key = k;
        mine.uniform = 0;
      }
    }
    mine.last = cur;
    mine.key = key;
  }

  // B: exclusive segmented scan of the carries across the CTA
  const Carry inclusive = warp_scan(mine, lane);
  if (lane == 31) warp_total[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    Carry c = lane < warps ? warp_total[lane] : mine;
    c = warp_scan(c, lane);
    if (lane < warps) warp_total[lane] = c;
  }
  __syncthreads();
  const Carry before_in_warp = shfl_up(inclusive, 1);
  bool in_run = lane > 0 || warp > 0;
  Carry carry = before_in_warp;
  if (warp > 0) {
    carry = lane > 0 ? combine(warp_total[warp - 1], before_in_warp)
                     : warp_total[warp - 1];
  }

  // C: rescan from the carry and write every element
  if (lo >= hi) return;
  int cur = carry.last;
  unsigned long long key = carry.key;
  int s = seg[lo];
  for (long long i = lo; i < hi; ++i) {
    const unsigned long long k = lane_key(w, eid, alive, i);
    if (in_run && s == cur) {
      key = k < key ? k : key;
    } else {
      cur = s;
      key = k;
      in_run = true;
    }
    const bool end_of_block = i == base + len - 1;
    const int next = end_of_block ? s : seg[i + 1];
    if (end_of_block || next != s) {
      cand_w[i] = from_order_bits(static_cast<unsigned int>(key >> 32));
      cand_e[i] = static_cast<int>(static_cast<unsigned int>(key) ^
                                   0x80000000u);
    } else {
      cand_w[i] = __uint_as_float(0x7f800000u);  // +inf
      cand_e[i] = kEidSentinel;
    }
    s = next;
  }
}

}  // namespace

// m elements in blocks of `block` (>= 1); every pointer is a device
// pointer to a contiguous buffer of m.  Returns the cudaError_t of the
// launch.
extern "C" int segmin_candidates_launch(const int* seg, const float* w,
                                        const int* eid,
                                        const unsigned char* alive,
                                        float* cand_w, int* cand_e,
                                        long long m, long long block,
                                        cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunk = (block + kMaxThreads - 1) / kMaxThreads;
  const long long per_chunk = (block + chunk - 1) / chunk;
  const unsigned int threads =
      static_cast<unsigned int>((per_chunk + 31) / 32 * 32);
  const long long blocks = (m + block - 1) / block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segmin_candidates_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                             stream>>>(seg, w, eid, alive, cand_w, cand_e, m,
                                       block, chunk);
  return static_cast<int>(cudaGetLastError());
}
