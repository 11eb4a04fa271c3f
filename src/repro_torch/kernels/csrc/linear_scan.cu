// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper.
//
// Replaces the Pallas kernel repro/kernels/linear_scan.py:linear_scan
// (the RG-LRU state update of every recurrent layer's full-sequence
// forward). a, b, h: (B, T, D), fp32 or bf16; the state is carried in
// fp32 and h is written in the inputs' dtype, as the TPU kernel does.
//
// Bound on the H100: every element of a and b is read once and h written
// once, 3 * B*T*D * elem bytes (63 MB in bf16 at the serving shape
// (1, 4096, 2560): 18.8 us at 3.35 TB/s); 2 flops an element are far
// below the card's rate, so bytes bound it.
//
// Design. The TPU kernel walks the time axis in order, carrying the
// (BB, D) state in VMEM from one grid step to the next; Hopper blocks run
// in no order, so one block owns a tile of 32 channels over the whole
// time axis and splits time among its 32 warps (a chunked scan inside
// the block, no second launch, no scratch in device memory):
//   1. warp w scans its chunk of ceil(T/32) steps from a zero state,
//      keeping the chunk's end state H_w and the product A_w of its a's;
//   2. warp 0 combines the 32 (A_w, H_w) in order in shared memory into
//      each chunk's incoming state;
//   3. every warp reruns its chunk from its incoming state and writes h.
// Lane = channel, so each time step of a warp is one coalesced row
// segment (128 B in fp32, 64 B in bf16); loads are issued 8 steps ahead
// of the dependent multiply-adds. Step 3 rereads a and b, which at B = 1
// may still sit in the 50 MB L2. A (1, T, 2560) input gives 80 blocks of
// 1024 threads: fewer than the 132 SMs, the price of needing no
// cross-block carry.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // channels per block, one per lane
constexpr int kChunks = 32;  // time chunks per block, one per warp
constexpr int kAhead = 8;    // time steps loaded ahead of their use

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Loads kAhead steps of a and b from step t0 (identity (1, 0) past t_end).
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           size_t base, int t0, int t_end,
                                           int D, float* av, float* bv) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int t = t0 + u;
    const size_t off = base + static_cast<size_t>(t) * D;
    av[u] = t < t_end ? to_f32(a[off]) : 1.f;
    bv[u] = t < t_end ? to_f32(b[off]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kChunks)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ h, int T_len, int D, int chunk_len) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int w = threadIdx.x / kLanes;
  const int d = blockIdx.x * kLanes + lane;
  const bool live = d < D;
  const size_t base = static_cast<size_t>(blockIdx.y) * T_len * D + d;
  const int t_begin = min(w * chunk_len, T_len);
  const int t_end = min(t_begin + chunk_len, T_len);
  __shared__ float s_a[kChunks][kLanes];
  __shared__ float s_h[kChunks][kLanes];
  float av[kAhead], bv[kAhead];

  // 1. the chunk's own scan from zero, and the product of its a's
  float A = 1.f, H = 0.f;
  if (live) {
    for (int t0 = t_begin; t0 < t_end; t0 += kAhead) {
      load_steps(a, b, base, t0, t_end, D, av, bv);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        A *= av[u];
        H = fmaf(av[u], H, bv[u]);
      }
    }
  }
  s_a[w][lane] = A;
  s_h[w][lane] = H;
  __syncthreads();

  // 2. each chunk's incoming state, in order (h_{-1} = 0)
  if (w == 0) {
    float carry = 0.f;
    for (int c = 0; c < kChunks; ++c) {
      const float a_c = s_a[c][lane], h_c = s_h[c][lane];
      s_h[c][lane] = carry;
      carry = fmaf(a_c, carry, h_c);
    }
  }
  __syncthreads();
  if (!live) return;

  // 3. rerun the chunk from its incoming state and write h
  float state = s_h[w][lane];
  for (int t0 = t_begin; t0 < t_end; t0 += kAhead) {
    load_steps(a, b, base, t0, t_end, D, av, bv);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      state = fmaf(av[u], state, bv[u]);
      if (t0 + u < t_end)
        store_f32(h + base + static_cast<size_t>(t0 + u) * D, state);
    }
  }
}

}  // namespace

extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  int dtype, int B, int T, int D,
                                  void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + kLanes - 1) / kLanes, B);
  const int chunk_len = (T + kChunks - 1) / kChunks;
  if (dtype == DTYPE_F32) {
    linear_scan_kernel<float><<<grid, kLanes * kChunks, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h), T, D, chunk_len);
  } else if (dtype == DTYPE_BF16) {
    linear_scan_kernel<__nv_bfloat16><<<grid, kLanes * kChunks, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(h), T, D, chunk_len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
