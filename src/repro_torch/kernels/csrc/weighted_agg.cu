// Fused trust-weighted aggregation (Eq. 12 + Eq. 13) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/weighted_agg.py:weighted_agg,
// whose body is a (1, N) @ (N, BD) product per D tile. Here the weights
// w (m,) are formed by the wrapper (as weighted_agg.py:35-37 does) and
// rows may belong to K segments (the engine's clouds):
//   out[k, d] = sum_{i : seg[i] == k} w[i] * G[i, d]
// With K = 1 and seg = 0 this is the TPU kernel's own function.
//
// Bound on the H100: reading G. On the main path G is (30, 545098) fp32,
// 65.4 MB in and 6.5 MB out, about 21 us at 3.35 TB/s; 2*m*D = 33 MFLOP
// is far below the fp32 rate. Design: each block owns a tile of
// kCols * kThreads columns; each thread keeps kCols columns x kMaxSeg
// fp32 sums in registers and walks the m rows once, so G is read once,
// with neighbouring threads on neighbouring addresses (coalesced), and
// the output is written once. No tensor cores: at m = 30 the product has
// one useful row per segment and the kernel is memory-bound either way.
// The segment id is the same for all threads of a row, so the select
// below is a uniform branch, not divergence.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;      // columns per thread (independent loads)
constexpr int kMaxSeg = 8;    // segments (clouds) held in registers

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const T* __restrict__ g, const float* __restrict__ w,
                    const int* __restrict__ seg, float* __restrict__ out,
                    int m, long long D, int K) {
  const long long base =
      static_cast<long long>(blockIdx.x) * (kCols * kThreads) + threadIdx.x;
  float acc[kMaxSeg][kCols];
#pragma unroll
  for (int k = 0; k < kMaxSeg; ++k)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[k][c] = 0.f;

  for (int i = 0; i < m; ++i) {
    const float wi = __ldg(w + i);
    const int si = seg ? __ldg(seg + i) : 0;
    const T* gr = g + static_cast<long long>(i) * D;
    float x[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const long long d = base + c * kThreads;
      x[c] = d < D ? to_f32(gr[d]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMaxSeg; ++k) {
      if (k == si) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[k][c] = fmaf(wi, x[c], acc[k][c]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxSeg; ++k) {
    if (k >= K) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const long long d = base + c * kThreads;
      if (d < D) out[k * D + d] = acc[k][c];
    }
  }
}

}  // namespace

extern "C" int weighted_agg_max_segments() { return kMaxSeg; }

extern "C" int weighted_agg_launch(const void* g, int dtype, const float* w,
                                   const int* seg, float* out, int m,
                                   long long D, int K, void* stream) {
  if (K < 1 || K > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tile = static_cast<long long>(kCols) * kThreads;
  const unsigned blocks = static_cast<unsigned>((D + tile - 1) / tile);
  if (dtype == DTYPE_F32) {
    weighted_agg_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), w, seg, out, m, D, K);
  } else if (dtype == DTYPE_BF16) {
    weighted_agg_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), w, seg, out, m, D, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
