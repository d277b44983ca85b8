// K2: fused relabel and self-loop kill, for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel repro/kernels/relabel/relabel.py: _relabel_kernel
// (called through relabel), the paper's RELABEL.
//
// What it computes, for each edge e < m:
//   ru[e] = labels[row(u[e])], rv[e] = labels[row(v[e])],
//   wp[e] = +inf where ru[e] == rv[e] or w[e] is not finite, else w[e],
// where row(i) is the reference's gather index: a negative i becomes
// i + n, and the result is clamped to [0, n - 1].  So no index reads
// outside the table (n >= 1; the wrapper refuses an empty one).
//
// Design.  The TPU kernel streams edge blocks through VMEM and keeps the
// whole label table resident there.  Here one thread per edge, in a
// grid-stride loop: coalesced int32 loads of u and v and f32 loads of w,
// the two label gathers through the read-only path (__ldg), and three
// coalesced stores.  The table is not staged in shared memory: it sits in
// the 50 MB L2 (4 MiB at n = 2^20, 128 KiB at the reference's
// post-contraction n <= 35 000), so the gathers cost L2 sectors, not
// device-memory bytes.
//
// Bound.  Device-memory bytes: u, v, w read once and ru, rv, wp written
// once, 24 B per edge, plus the 4 n B table read once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 132 SMs, 16 blocks each
constexpr float kMaxFinite = 3.402823466e38f;

__device__ __forceinline__ long long row(int i, long long n) {
  long long j = i < 0 ? static_cast<long long>(i) + n : i;
  j = j < 0 ? 0 : j;
  return j < n ? j : n - 1;
}

__global__ void relabel_kernel(const int* __restrict__ u,
                               const int* __restrict__ v,
                               const float* __restrict__ w,
                               const int* __restrict__ labels,
                               int* __restrict__ ru, int* __restrict__ rv,
                               float* __restrict__ wp, long long m,
                               long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < m; e += stride) {
    const int a = __ldg(labels + row(u[e], n));
    const int b = __ldg(labels + row(v[e], n));
    const float x = w[e];
    ru[e] = a;
    rv[e] = b;
    // fabsf(NaN) <= max is false, so NaN and +-inf are dead
    wp[e] = (a == b || !(fabsf(x) <= kMaxFinite))
                ? __uint_as_float(0x7f800000u)
                : x;
  }
}

}  // namespace

// m edges, an n-entry label table (n >= 1); every pointer is a device
// pointer to a contiguous buffer of that length.  Returns the cudaError_t
// of the launch.
extern "C" int relabel_launch(const int* u, const int* v, const float* w,
                              const int* labels, int* ru, int* rv,
                              float* wp, long long m, long long n,
                              cudaStream_t stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (m + kThreads - 1) / kThreads;
  const unsigned int blocks =
      static_cast<unsigned int>(want < kMaxBlocks ? want : kMaxBlocks);
  relabel_kernel<<<blocks, kThreads, 0, stream>>>(u, v, w, labels, ru, rv,
                                                  wp, m, n);
  return static_cast<int>(cudaGetLastError());
}
