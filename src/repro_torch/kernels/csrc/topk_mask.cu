// Top-k threshold mask for gradient sparsification, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/topk_mask.py:topk_mask:
//   out[i, d] = |G[i, d]| >= thr[i] ? G[i, d] : 0      (ties kept)
// Rows i >= n_thr take thr = +inf (all zero), the TPU kernel's padded-row
// semantics. The threshold (k-th largest |g| per row) is computed
// outside, as lax.top_k is outside the Pallas body. With fp16_roundtrip
// set (fp32 input only) the kept value also passes through fp16 and back
// with round-to-nearest-even, fusing the top-k codec's wire precision
// (compress/topk.py:69) into the same pass.
//
// Bound on the H100: bytes. On the main path G is (3, 545098) fp32:
// 6.5 MB in, 6.5 MB out, about 4 us at 3.35 TB/s. Design: a purely
// elementwise grid-stride pass, one row per blockIdx.y so the threshold
// is one broadcast load per block, neighbouring threads on neighbouring
// addresses. CUDA rather than Triton keeps one tool chain (nvcc) for all
// of the port's kernels.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T, bool kFp16>
__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const T* __restrict__ g, const float* __restrict__ thr,
                 T* __restrict__ out, long long D, int n_thr) {
  const int row = blockIdx.y;
  const float t = row < n_thr ? thr[row] : __int_as_float(0x7f800000);
  const T* gr = g + static_cast<long long>(row) * D;
  T* orow = out + static_cast<long long>(row) * D;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       d < D; d += stride) {
    const T v = gr[d];
    const bool keep = fabsf(to_f32(v)) >= t;
    if constexpr (kFp16) {
      orow[d] = keep ? __half2float(__float2half_rn(to_f32(v))) : 0.f;
    } else {
      orow[d] = keep ? v : zero_of<T>();
    }
  }
}

}  // namespace

extern "C" int topk_mask_launch(const void* g, int dtype, const float* thr,
                                void* out, int n, long long D, int n_thr,
                                int fp16_roundtrip, void* stream) {
  if (n <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long want = (D + kThreads - 1) / kThreads;
  // enough blocks to fill the card several times over; each strides
  const unsigned bx = static_cast<unsigned>(want < 1024 ? want : 1024);
  const dim3 grid(bx, static_cast<unsigned>(n));
  if (dtype == DTYPE_F32) {
    if (fp16_roundtrip)
      topk_mask_kernel<float, true><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(g), thr, static_cast<float*>(out), D,
          n_thr);
    else
      topk_mask_kernel<float, false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(g), thr, static_cast<float*>(out), D,
          n_thr);
  } else if (dtype == DTYPE_BF16 && !fp16_roundtrip) {
    topk_mask_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), thr,
        static_cast<__nv_bfloat16*>(out), D, n_thr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
