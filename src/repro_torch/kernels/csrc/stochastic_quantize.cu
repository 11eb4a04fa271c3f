// QSGD stochastic-rounding quantization for Hopper.
//
// Replaces the Pallas kernel repro/kernels/quantize.py:stochastic_quantize.
// Per element of x (n, D), with the row's scale s and uniform noise u:
//   v = x / max(s, eps) * L
//   q = sign(v) * min(floor(|v| + u), L)                  (int32)
// Mode (a), q != nullptr: write q (the TPU kernel's function).
// Mode (b), x_hat and res != nullptr: the QSGD codec's round trip fused
// into the same pass, x_hat = float(q) * s / L with the raw scale
// (ref.dequantize_ref) and the error-feedback residual res = x - x_hat.
// Every operation is IEEE-rounded in the reference's order (explicit
// __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts
// nothing into an FMA), so q equals the reference's bit for bit.
//
// Bound on the H100: bytes. On the main path x is (30, 545098) fp32 on
// the client wire and (3, 545098) on the edge wire: mode (b) reads x and
// u and writes x_hat and res, 4 x 65.4 MB = 78 us at 3.35 TB/s for the
// client wire. Design: a purely elementwise grid-stride pass with one
// row per blockIdx.y, so the row's scale is one broadcast load per
// thread, neighbouring threads on neighbouring addresses. (D = 545,098
// is not a multiple of 4, so rows are not 16-byte aligned and the pass
// stays with 4-byte accesses.)
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ noise, int levels, float eps,
                int* __restrict__ q_out, float* __restrict__ x_hat,
                float* __restrict__ res, long long D) {
  const int row = blockIdx.y;
  const float s = scale[row];
  const float s_eps = fmaxf(s, eps);
  const float L = static_cast<float>(levels);
  const long long base = static_cast<long long>(row) * D;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       d < D; d += stride) {
    const long long i = base + d;
    const float xv = to_f32(x[i]);
    const float v = __fmul_rn(__fdiv_rn(xv, s_eps), L);
    const float xi = fminf(floorf(__fadd_rn(fabsf(v), noise[i])), L);
    // sign(v) * xi, exact: xi is an integer in [0, L]
    const int m = static_cast<int>(xi);
    const int q = v > 0.f ? m : (v < 0.f ? -m : 0);
    if (q_out != nullptr) {
      q_out[i] = q;
    } else {
      const float xh = __fdiv_rn(__fmul_rn(static_cast<float>(q), s), L);
      x_hat[i] = xh;
      res[i] = __fsub_rn(xv, xh);
    }
  }
}

}  // namespace

extern "C" int stochastic_quantize_launch(const void* x, int dtype,
                                          const float* scale,
                                          const float* noise, int levels,
                                          float eps, int* q, float* x_hat,
                                          float* res, int n, long long D,
                                          void* stream) {
  if (n <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  // exactly one mode: q, or both x_hat and res
  const bool mode_a = q != nullptr && x_hat == nullptr && res == nullptr;
  const bool mode_b = q == nullptr && x_hat != nullptr && res != nullptr;
  if (n > 65535 || levels < 1 || !(mode_a || mode_b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (D + kThreads - 1) / kThreads;
  // enough blocks to fill the card several times over; each strides
  const dim3 grid(static_cast<unsigned>(want < 1024 ? want : 1024),
                  static_cast<unsigned>(n));
  if (dtype == DTYPE_F32) {
    quantize_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), scale, noise, levels, eps, q, x_hat,
        res, D);
  } else if (dtype == DTYPE_BF16) {
    quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, noise, levels, eps, q,
        x_hat, res, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
