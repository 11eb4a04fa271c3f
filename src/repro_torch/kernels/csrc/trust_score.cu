// Fused per-client trust statistics (Eq. 7 + Eq. 11) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/trust_score.py:trust_score.
// Per row i of G (m, L):
//   phi_i  = ReLU(cos(g_i, gbar)) * ||g_i||
//   ts_i   = ReLU(cos(g_i, ref_{c(i)})) * rep_i
//   norm_i = ||g_i||
// where gbar (L,) is precomputed outside (as the TPU wrapper does) and
// ref is either one (L,) row (ref_idx == nullptr, the TPU kernel's own
// mode) or a (K, L) matrix gathered per row through ref_idx (m,) — the
// engine's own-cloud reference.
//
// Bound on the H100: the main path's G is (30, 1290) fp32, ~155 KB,
// about 0.05 us of HBM traffic; the launch itself (a few us) dominates.
// Design: one block per row, 256 threads striding over L with five
// running fp32 sums (<g,gbar>, <g,ref>, ||g||^2, ||gbar||^2, ||ref||^2),
// one warp-shuffle + shared-memory reduction, and the finalize step of
// the TPU kernel (max(., eps) and ReLU) in thread 0. m blocks of 256
// threads run in one wave; nothing is staged in shared memory because
// every element is read once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
trust_score_kernel(const T* __restrict__ g, const float* __restrict__ gbar,
                   const float* __restrict__ ref,
                   const int* __restrict__ ref_idx,
                   const float* __restrict__ rep, float* __restrict__ phi,
                   float* __restrict__ ts, float* __restrict__ norms, int L,
                   float eps) {
  const int row = blockIdx.x;
  const T* gr = g + static_cast<size_t>(row) * L;
  const float* rr =
      ref + (ref_idx ? static_cast<size_t>(ref_idx[row]) * L : 0);
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < L; j += kThreads) {
    const float x = to_f32(gr[j]);
    const float b = gbar[j];
    const float r = rr[j];
    s[0] = fmaf(x, b, s[0]);
    s[1] = fmaf(x, r, s[1]);
    s[2] = fmaf(x, x, s[2]);
    s[3] = fmaf(b, b, s[3]);
    s[4] = fmaf(r, r, s[4]);
  }
  __shared__ float part[kThreads / 32][5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float v = warp_sum(s[q]);
    if (lane == 0) part[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kThreads / 32; ++w)
#pragma unroll
      for (int q = 0; q < 5; ++q) acc[q] += part[w][q];
    const float nrm = sqrtf(fmaxf(acc[2], 0.f));
    const float nbar = sqrtf(fmaxf(acc[3], 0.f));
    const float nref = sqrtf(fmaxf(acc[4], 0.f));
    const float cos_bar = acc[0] / fmaxf(nrm * nbar, eps);
    const float cos_ref = acc[1] / fmaxf(nrm * nref, eps);
    phi[row] = fmaxf(cos_bar, 0.f) * nrm;
    ts[row] = fmaxf(cos_ref, 0.f) * rep[row];
    norms[row] = nrm;
  }
}

}  // namespace

extern "C" int trust_score_launch(const void* g, int dtype, const float* gbar,
                                  const float* ref, const int* ref_idx,
                                  const float* rep, float* phi, float* ts,
                                  float* norms, int m, int L, float eps,
                                  void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    trust_score_kernel<float><<<m, kThreads, 0, s>>>(
        static_cast<const float*>(g), gbar, ref, ref_idx, rep, phi, ts, norms,
        L, eps);
  } else if (dtype == DTYPE_BF16) {
    trust_score_kernel<__nv_bfloat16><<<m, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), gbar, ref, ref_idx, rep, phi,
        ts, norms, L, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
