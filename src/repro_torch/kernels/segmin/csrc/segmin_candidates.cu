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
// Design.  A CTA of kThreads threads holds a tile of kE * kThreads
// elements, kE consecutive ones per thread, loaded once with one 16-byte
// load each of seg, w and eid and one 4-byte load of alive.  (w, eid)
// folds into one order-preserving 64-bit key as in K1, so the
// lexicographic min is one integer min.  A block of at most one tile
// shares its CTA with as many whole blocks as fit; a larger block has a
// CTA of its own that walks it tile by tile, carrying the open run
// across tiles.  An element is a run head where its block starts or its
// seg differs from the element before.  The scan carries two fields, a
// head flag and a key:
//     (h1, k1) + (h2, k2) = (h1 | h2, h2 ? k2 : min(k1, k2)),
// where a flag marks a head inside the stretch: three shuffles a step.
// Each thread folds its chunk into one carry, a warp scans the carries
// by shuffles, and the warp totals meet through shared memory behind
// one barrier a tile.  The seg before a chunk and after it come from the
// neighbouring lanes by shuffle, across warps from shared memory, so no
// element is read twice; the last thread of a tile with more tiles to
// come holds its chunk until the next tile's first seg is known.  The
// candidates go out as one float4 and one int4 per thread.  Where a
// chunk is cut by the end of its span, or a pointer is not aligned, or a
// span is not a multiple of kE (a large block of such a size), the same
// kernel loads and stores element by element.  Planned on the host by
// kernels/segmin/plan.py: k3_plan.
//
// Bound.  Device-memory bytes: seg, w, eid (12 B) and alive (1 B) read
// once and cand_w, cand_eid (8 B) written once, 21 B per element.

#include <cstdint>

#include <cuda_runtime.h>

// The launch constants are defined once, in kernels/segmin/plan.py
// (CUDA_CONSTANTS), and come in as -D flags from kernels/_build.py.
#if !defined(K3_E) || !defined(K3_THREADS)
#error "build with -DK3_E -DK3_THREADS"
#endif

namespace {

constexpr int kEidSentinel = 1 << 30;
constexpr int kE = K3_E;
constexpr int kThreads = K3_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kE * kThreads;    // plan.K3_TILE
static_assert(kE == 4, "a chunk is one 16-byte load of each input");
static_assert(kThreads % 32 == 0, "whole warps");
constexpr unsigned int kFullMask = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;  // neutral for the min

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

__device__ __forceinline__ unsigned long long lane_key(bool alive, float w,
                                                       int eid) {
  return alive ? pack(w, eid)
               : pack(__uint_as_float(0x7f800000u), kEidSentinel);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// The carry of a stretch: does a run start inside it, and the min key
// since the last such start (of the whole stretch if none does).
struct Run {
  unsigned long long key;
  unsigned int head;
};

// `a` directly before `b`.  Associative: the segmented-scan operator.
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  return Run{b.head ? b.key : kmin(a.key, b.key), a.head | b.head};
}

__device__ __forceinline__ Run shfl_up(const Run& c, int d) {
  return Run{__shfl_up_sync(kFullMask, c.key, d),
             __shfl_up_sync(kFullMask, c.head, d)};
}

__device__ __forceinline__ void decode(unsigned long long key, float& w,
                                       int& e) {
  w = from_order_bits(static_cast<unsigned int>(key >> 32));
  e = static_cast<int>(static_cast<unsigned int>(key) ^ 0x80000000u);
}

__device__ __forceinline__ void store_chunk(float* __restrict__ cand_w,
                                            int* __restrict__ cand_e,
                                            long long c0, long long s1,
                                            bool vec, const float (&ow)[kE],
                                            const int (&oe)[kE]) {
  if (vec && c0 + kE <= s1) {
    __stcs(reinterpret_cast<float4*>(cand_w + c0),
           make_float4(ow[0], ow[1], ow[2], ow[3]));
    __stcs(reinterpret_cast<int4*>(cand_e + c0),
           make_int4(oe[0], oe[1], oe[2], oe[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (c0 + j < s1) {
      cand_w[c0 + j] = ow[j];
      cand_e[c0 + j] = oe[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) segmin_candidates_kernel(
    const int* __restrict__ seg, const float* __restrict__ w,
    const int* __restrict__ eid, const unsigned char* __restrict__ alive,
    float* __restrict__ cand_w, int* __restrict__ cand_e, long long m,
    long long block, long long span, int vec_ok) {
  // per warp: its first seg, whether that element starts a block, its
  // last seg, and its scan total; double-buffered across tiles
  __shared__ int first_seg[2][kWarps];
  __shared__ int lead_start[2][kWarps];
  __shared__ int last_seg[2][kWarps];
  __shared__ Run total[2][kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long s0 = static_cast<long long>(blockIdx.x) * span;
  const long long s1 = (m - s0 < span) ? m : s0 + span;
  const bool vec = vec_ok != 0;

  Run carry{kNoKey, 1u};  // the tiles before; the first tile starts a block
  int before_tile = 0;    // seg of the element before the tile
  // the last thread's chunk, held until the next tile's first seg is known
  float hold_w[kE];
  int hold_e[kE];
  unsigned long long hold_key = 0;
  int hold_seg = 0;
  bool hold_start = false;
  long long hold_c0 = -1;

  int buf = 0;
  for (long long t0 = s0; t0 < s1; t0 += kTile, buf ^= 1) {
    const long long c0 = t0 + static_cast<long long>(t) * kE;

    // load the chunk once
    int sg[kE];
    unsigned long long k[kE];
    if (vec && c0 + kE <= s1) {
      const int4 s4 = __ldcs(reinterpret_cast<const int4*>(seg + c0));
      const float4 w4 = __ldcs(reinterpret_cast<const float4*>(w + c0));
      const int4 e4 = __ldcs(reinterpret_cast<const int4*>(eid + c0));
      const unsigned int a4 =
          __ldcs(reinterpret_cast<const unsigned int*>(alive + c0));
      sg[0] = s4.x; sg[1] = s4.y; sg[2] = s4.z; sg[3] = s4.w;
      k[0] = lane_key(a4 & 0xffu, w4.x, e4.x);
      k[1] = lane_key((a4 >> 8) & 0xffu, w4.y, e4.y);
      k[2] = lane_key((a4 >> 16) & 0xffu, w4.z, e4.z);
      k[3] = lane_key(a4 >> 24, w4.w, e4.w);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const long long i = c0 + j;
        sg[j] = 0;
        k[j] = kNoKey;
        if (i < s1) {
          sg[j] = __ldcs(seg + i);
          k[j] = lane_key(alive[i] != 0, __ldcs(w + i), __ldcs(eid + i));
        }
      }
    }

    // block starts at the chunk's elements and the one after it
    bool start[kE + 1];
    {
      const long long off = c0 - s0;
      long long r = block > kTile
                        ? off
                        : static_cast<long long>(
                              static_cast<unsigned int>(off) %
                              static_cast<unsigned int>(block));
#pragma unroll
      for (int j = 0; j <= kE; ++j) {
        start[j] = r == 0;
        if (++r == block) r = 0;
      }
    }

    // neighbours' seg: by shuffle in the warp, through shared memory
    // across warps
    const int prev = __shfl_up_sync(kFullMask, sg[kE - 1], 1);
    const int next = __shfl_down_sync(kFullMask, sg[0], 1);
    if (lane == 0) {
      first_seg[buf][warp] = sg[0];
      lead_start[buf][warp] = start[0];
    }
    if (lane == 31) last_seg[buf][warp] = sg[kE - 1];

    // heads inside the chunk; lane 0's first head waits for the barrier
    bool head[kE];
    head[0] = start[0] || sg[0] != prev;
#pragma unroll
    for (int j = 1; j < kE; ++j) head[j] = start[j] || sg[j] != sg[j - 1];
    Run mine{k[0], lane > 0 && head[0]};
#pragma unroll
    for (int j = 1; j < kE; ++j) {
      mine.key = head[j] ? k[j] : kmin(mine.key, k[j]);
      mine.head |= head[j];
    }

    // inclusive scan in the warp
    Run inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run up = shfl_up(inc, d);
      if (lane >= d) inc = combine(up, inc);
    }
    if (lane == 31) total[buf][warp] = inc;
    const Run up = shfl_up(inc, 1);
    __syncthreads();

    // the run open before each warp: the tiles before, then each warp's
    // boundary (a key-less head where its first element starts a run)
    // and total
    Run before_warp{kNoKey, 0u};
    bool lead_head = false;
    Run pre = carry;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int prev_seg = v ? last_seg[buf][v - 1] : before_tile;
      const bool h = lead_start[buf][v] || first_seg[buf][v] != prev_seg;
      pre = combine(pre, Run{kNoKey, h});
      if (v == warp) {
        before_warp = pre;
        lead_head = h;
      }
      pre = combine(pre, total[buf][v]);
    }
    const Run tile_total = pre;
    if (lane == 0) head[0] = lead_head;
    const Run excl = lane ? combine(before_warp, up) : before_warp;

    // the last thread's held chunk from the tile before ends its run
    // where this tile's first element starts one
    if (hold_c0 >= 0) {
      float ow;
      int oe;
      if (hold_start || first_seg[buf][0] != hold_seg) {
        decode(hold_key, ow, oe);
      } else {
        ow = __uint_as_float(0x7f800000u);
        oe = kEidSentinel;
      }
      hold_w[kE - 1] = ow;
      hold_e[kE - 1] = oe;
      store_chunk(cand_w, cand_e, hold_c0, s1, vec, hold_w, hold_e);
      hold_c0 = -1;
    }

    // the seg after the chunk
    int after = next;
    if (lane == 31 && warp + 1 < kWarps) after = first_seg[buf][warp + 1];
    const bool last_thread = t == kThreads - 1;
    const bool more_tiles = t0 + kTile < s1;

    // rescan the chunk from the open run and emit run ends
    float ow[kE];
    int oe[kE];
    unsigned long long run = excl.key;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      run = head[j] ? k[j] : kmin(run, k[j]);
      const long long i = c0 + j;
      bool end;
      if (i + 1 >= s1) {
        end = true;
      } else if (j + 1 < kE) {
        end = head[j + 1];
      } else {
        end = start[kE] || after != sg[kE - 1];
      }
      if (end) {
        decode(run, ow[j], oe[j]);
      } else {
        ow[j] = __uint_as_float(0x7f800000u);  // +inf
        oe[j] = kEidSentinel;
      }
    }
    if (last_thread && more_tiles) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        hold_w[j] = ow[j];
        hold_e[j] = oe[j];
      }
      hold_key = run;
      hold_seg = sg[kE - 1];
      hold_start = start[kE];
      hold_c0 = c0;
    } else {
      store_chunk(cand_w, cand_e, c0, s1, vec, ow, oe);
    }

    carry = tile_total;
    before_tile = last_seg[buf][kWarps - 1];
  }
}

}  // namespace

// m elements in blocks of `block` (>= 1), one CTA per `span` elements
// (whole blocks, or one block), from kernels/segmin/plan.py: k3_plan;
// `vec` allows 16-byte loads and stores (aligned pointers, span a
// multiple of 4).  Every pointer is a device pointer to a contiguous
// buffer of m.  Returns the cudaError_t of the launch.
extern "C" int segmin_candidates_launch(const int* seg, const float* w,
                                        const int* eid,
                                        const unsigned char* alive,
                                        float* cand_w, int* cand_e,
                                        long long m, long long block,
                                        long long span, long long ctas,
                                        long long vec, cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (block < 1 || span < 1 || ctas < 1 || ctas > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  segmin_candidates_kernel<<<static_cast<unsigned int>(ctas), kThreads, 0,
                             stream>>>(seg, w, eid, alive, cand_w, cand_e, m,
                                       block, span, static_cast<int>(vec));
  return static_cast<int>(cudaGetLastError());
}
