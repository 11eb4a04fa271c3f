// Fused per-client trust feature pass for Hopper.
//
// Replaces the Pallas kernel repro/kernels/trust_features.py:trust_features.
// Per row i of G (m, D), against its reference row r_i (refs (m, D) when
// ref_idx == nullptr, the TPU kernel's own mode, or row ref_idx[i] of a
// (K, D) matrix, the engine's own-cloud reference), the selected mean
// gbar (D,), the selected median norm med (a device scalar, NaN or <= 0
// sanitized to 1 here) and the delivery weight w_i:
//   f0 = 1 / (1 + |log(max(||g||, eps) / med)|)
//   f1 = ReLU(<g, r> / max(||g|| ||r||, eps))
//   f2 = #{d : g_d * gbar_d > 0} / D
//   f3 = x / (1 + x),  x = f1 * min(ratio, 1 / ratio),  ratio = max(||g||, eps) / med
// each times w_i, written as out (m, 4) fp32 — the TPU kernel's _finalize.
//
// Bound on the H100: the main path's G is (30, 1290) fp32, ~0.3 MB with
// the gathered refs, about 0.1 us of HBM traffic; the launch (a few us)
// dominates, as for trust_score. Design: one block per row, 256 threads
// striding over D with three running fp32 sums (<g,r>, ||g||^2, ||r||^2)
// and an integer count of sign agreements, one warp-shuffle +
// shared-memory reduction, and the finalize in thread 0. m blocks run in
// one wave; nothing is staged in shared memory because every element is
// read once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
trust_features_kernel(const T* __restrict__ g, const T* __restrict__ refs,
                      const int* __restrict__ ref_idx,
                      const float* __restrict__ gbar,
                      const float* __restrict__ med_in,
                      const float* __restrict__ w, float* __restrict__ out,
                      int D, float eps) {
  const int row = blockIdx.x;
  const T* gr = g + static_cast<size_t>(row) * D;
  const T* rr =
      refs + static_cast<size_t>(ref_idx ? ref_idx[row] : row) * D;
  float s[3] = {0.f, 0.f, 0.f};
  int agree = 0;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    const float x = to_f32(gr[j]);
    const float r = to_f32(rr[j]);
    s[0] = fmaf(x, r, s[0]);
    s[1] = fmaf(x, x, s[1]);
    s[2] = fmaf(r, r, s[2]);
    // the product's sign, as the reference tests it (an underflow to 0
    // is a disagreement there too)
    agree += __fmul_rn(x, gbar[j]) > 0.f;
  }
  __shared__ float part[kThreads / 32][3];
  __shared__ int part_agree[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float v = warp_sum(s[q]);
    if (lane == 0) part[warp][q] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    agree += __shfl_xor_sync(0xffffffffu, agree, off);
  if (lane == 0) part_agree[warp] = agree;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc[3] = {0.f, 0.f, 0.f};
    int n_agree = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
#pragma unroll
      for (int q = 0; q < 3; ++q) acc[q] += part[k][q];
      n_agree += part_agree[k];
    }
    const float norm_g = sqrtf(fmaxf(acc[1], 0.f));
    const float norm_r = sqrtf(fmaxf(acc[2], 0.f));
    float med = *med_in;
    if (isnan(med) || !(med > 0.f)) med = 1.f;
    const float wi = w[row];
    const float f0 = 1.f / (1.f + fabsf(logf(fmaxf(norm_g, eps) / med)));
    const float f1 = fmaxf(acc[0] / fmaxf(norm_g * norm_r, eps), 0.f);
    const float f2 = static_cast<float>(n_agree) / static_cast<float>(D);
    const float ratio = fmaxf(norm_g, eps) / med;
    const float x = f1 * fminf(ratio, 1.f / ratio);
    const float f3 = x / (1.f + x);
    float* o = out + static_cast<size_t>(row) * 4;
    o[0] = f0 * wi;
    o[1] = f1 * wi;
    o[2] = f2 * wi;
    o[3] = f3 * wi;
  }
}

}  // namespace

extern "C" int trust_features_launch(const void* g, int dtype,
                                     const void* refs, const int* ref_idx,
                                     const float* gbar, const float* med,
                                     const float* w, float* out, int m, int D,
                                     float eps, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    trust_features_kernel<float><<<m, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(refs),
        ref_idx, gbar, med, w, out, D, eps);
  } else if (dtype == DTYPE_BF16) {
    trust_features_kernel<__nv_bfloat16><<<m, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(refs), ref_idx, gbar, med, w, out,
        D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
