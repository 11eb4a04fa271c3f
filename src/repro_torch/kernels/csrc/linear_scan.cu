// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper: a
// single-pass chunked scan over thread-block clusters.
//
// Replaces the Pallas kernel repro/kernels/linear_scan.py:linear_scan
// (the RG-LRU state update of every recurrent layer's full-sequence
// forward). a, b, h: (B, T, D), fp32 or bf16; the state is carried in
// fp32 and h is written in the inputs' dtype, as the TPU kernel does.
//
// Bound on the H100: every element of a and b is read once and h written
// once, 3 * B*T*D * elem bytes (63 MB in bf16 at the serving shape
// (1, 4096, 2560): 18.8 us at 3.35 TB/s; 37.6 us in fp32); 2 flops an
// element are far below the card's rate, so bytes bound it. The kernel
// reads a and b from device memory once and writes h once.
//
// Design. The TPU kernel walks the time axis in order, carrying the
// state in VMEM from one grid step to the next; Hopper blocks run in no
// order. Here a block owns kLanes = 32 channels (one per lane) and, in
// each segment of the time axis, a chunk of kWarps * rows steps, one
// sub-chunk of `rows` steps per warp; a cluster of kCluster = 4 blocks
// owns 4 consecutive chunks (one segment) of one channel tile and walks
// the segments in order, so the carry between chunks travels through
// distributed shared memory, not device memory and not a second launch.
// For each segment:
//   1. each warp has its sub-chunk of a and b in shared memory: copied
//      with 16-byte cp.async while the warp worked on the segment before
//      (two tiles a warp, one commit group a segment), or with plain
//      loads where D is ragged or a row is not 16-byte aligned;
//   2. each warp scans its sub-chunk from zero, keeping per channel the
//      product A of its a's and its end state H; every warp folds the 8
//      warps' (A, H) in order into its own prefix and the block's
//      summary;
//   3. warp 0 writes the block's summary into the shared memory of all
//      4 blocks of the cluster, the cluster syncs, and every warp folds
//      the 4 summaries in rank order: the ranks below its block's give
//      the block's incoming state, all 4 the state at the end of the
//      segment, the next segment's h_{-1} (the same bits in every block);
//   4. each warp reruns its sub-chunk from shared memory from its
//      incoming state and writes h, one coalesced row segment a step.
// Blocks only write into each other's shared memory, before a barrier
// that the written block waits on, and never read it: the summary slots
// alternate by segment parity, so a segment's writes never meet the
// previous segment's reads, one barrier a segment suffices, and once the
// last barrier completes no access to another block's shared memory is
// pending, so a block may exit. A first arrive, waited on before the
// first write, makes sure every block of the cluster runs.
//
// Sizes. Blocks of 256 threads with two 32 KB (a, b) tiles (rows = 32
// steps a warp in bf16, 16 in fp32) and 4 KB of summaries: three blocks
// an SM. At (1, 4096, 2560) the grid is (80, 4, 1) = 320 blocks, 80
// clusters, all resident at once (three blocks an SM hold 396), and
// a cluster walks 4 segments of 1,024 steps (bf16; fp32 8 of 512).
// 8-block clusters were slower on the card: 640 of these blocks do not
// fit at once (45 clusters do), and blocks small enough to fit doubled
// the segments, each a chain of copy, scan, fold, barrier and rerun.
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;    // channels per block, one per lane
constexpr int kWarps = 8;     // time sub-chunks per block, one per warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kCluster = 4;   // blocks per cluster: consecutive chunks
constexpr int kStages = 2;    // (a, b) tiles a warp holds: double buffer

// steps a warp stages at most a segment: 32 KB (a, b) tiles either way
template <typename E> constexpr int max_rows() { return 16; }
template <> constexpr int max_rows<__nv_bfloat16>() { return 32; }

template <typename E>
constexpr size_t smem_bytes(int rows) {   // kStages (a, b) tiles
  return 2 * kStages * sizeof(E) * kWarps * kLanes *
         static_cast<size_t>(rows);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// barrier.cluster: arrive releases, wait acquires (their default)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copies rows row0 .. row0 + n - 1 (n <= rows; a row is one time step of
// one batch element) of a and b into the warp's tiles wa, wb
// ([rows][kLanes] each): 16-byte cp.async in one commit group (kVec), or
// plain loads, each lane its own column.
template <typename E, bool kVec>
__device__ __forceinline__ void stage(const E* __restrict__ a,
                                      const E* __restrict__ b, E* wa, E* wb,
                                      size_t row0, int n, int d0, int D,
                                      int lane) {
  __syncwarp();   // the warp is done with what these tiles held
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(E);       // elements in 16 bytes
    constexpr int kPieces = kLanes / kPer;     // 16-byte pieces a row
    for (int k = lane; k < n * kPieces; k += kLanes) {
      const int i = k / kPieces, col = (k % kPieces) * kPer;
      if (d0 + col < D) {    // D % kPer == 0: a piece is all in or out
        const size_t off = (row0 + i) * D + d0 + col;
        cp_async16(wa + i * kLanes + col, a + off);
        cp_async16(wb + i * kLanes + col, b + off);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");   // maybe empty
  } else {
    const int d = d0 + lane;
    if (d < D) {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const size_t off = (row0 + i) * D + d;
        wa[i * kLanes + lane] = a[off];
        wb[i * kLanes + lane] = b[off];
      }
    }
  }
}

// Waits until all but the newest kStages - 1 commit groups of this
// thread have landed (the segment about to be scanned), then makes the
// warp's copies visible to the whole warp.
template <bool kVec>
__device__ __forceinline__ void staged() {
  if constexpr (kVec) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1)
                 : "memory");
    __syncwarp();
  }
}

template <typename E, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
linear_scan_kernel(const E* __restrict__ a, const E* __restrict__ b,
                   E* __restrict__ h, int T_len, int D, int rows,
                   int n_seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_wa[kWarps][kLanes];   // each warp's (prod a, h_end)
  __shared__ float s_wh[kWarps][kLanes];
  // every block's summary, written by that block into all the cluster's
  // blocks; two slots, by segment parity, so a segment's writes never
  // meet the previous segment's reads
  __shared__ float s_ca[2][kCluster][kLanes];
  __shared__ float s_ch[2][kCluster][kLanes];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int d0 = blockIdx.x * kLanes, d = d0 + lane;
  const size_t batch_row = static_cast<size_t>(blockIdx.z) * T_len;
  const int tile = kWarps * rows * kLanes;   // elements of one a or b tile
  E* const warp_tile = reinterpret_cast<E*>(smem) + w * rows * kLanes;
  const int tc = kWarps * rows;
  // the warp's first step in segment j, and its steps there (none past
  // the last segment)
  const auto first = [&](int j) {
    return (j * kCluster + rank) * tc + w * rows;
  };
  const auto steps = [&](int j) {
    return j < n_seg ? max(0, min(rows, T_len - first(j))) : 0;
  };
  // segment j goes to tile j % kStages; one commit group a segment, empty
  // past the last one
  const auto stage_seg = [&](int j) {
    E* const ta = warp_tile + 2 * (j % kStages) * tile;
    stage<E, kVec>(a, b, ta, ta + tile, batch_row + first(j), steps(j), d0,
                   D, lane);
  };
  float carry = 0.f;   // h at the start of the segment

  for (int j = 0; j < kStages - 1; ++j) stage_seg(j);
  cluster_arrive();   // this block runs: the others may write into it
  for (int seg = 0; seg < n_seg; ++seg) {
    const int p = seg & 1;
    E* const wa = warp_tile + 2 * (seg % kStages) * tile;
    E* const wb = wa + tile;
    const int t_w = first(seg), n = steps(seg);
    // 1. the next segment's copies go out, into the tile the last one
    // has finished with; then this segment's have landed
    stage_seg(seg + kStages - 1);
    staged<kVec>();

    // 2. scan the sub-chunk from zero; fold the block's warps in order
    float A = 1.f, H = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float av = to_f32(wa[i * kLanes + lane]);
      A *= av;
      H = fmaf(av, H, to_f32(wb[i * kLanes + lane]));
    }
    s_wa[w][lane] = A;
    s_wh[w][lane] = H;
    __syncthreads();
    // the fold of warps 0..w-1 (this warp's prefix) and of all (the
    // block's summary), by every warp
    float pre_a = 1.f, pre_h = 0.f, blk_a = 1.f, blk_h = 0.f;
#pragma unroll 4
    for (int v = 0; v < kWarps; ++v) {
      if (v == w) {
        pre_a = blk_a;
        pre_h = blk_h;
      }
      const float av = s_wa[v][lane];
      blk_h = fmaf(av, blk_h, s_wh[v][lane]);
      blk_a *= av;
    }

    // 3. the summary into every block of the cluster, sync, fold in order
    if (seg == 0) cluster_wait();   // every block of the cluster runs
    if (w == 0) {
#pragma unroll 1
      for (int r = 0; r < kCluster; ++r) {
        cluster.map_shared_rank(&s_ca[p][rank][lane], r)[0] = blk_a;
        cluster.map_shared_rank(&s_ch[p][rank][lane], r)[0] = blk_h;
      }
    }
    cluster_arrive();
    cluster_wait();
    float in = carry;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r == rank) in = carry;
      carry = fmaf(s_ca[p][r][lane], carry, s_ch[p][r][lane]);
    }

    // 4. rerun the sub-chunk from its incoming state and write h
    float state = fmaf(pre_a, in, pre_h);
    if (d < D) {
      E* out = h + (batch_row + t_w) * D + d;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        state = fmaf(to_f32(wa[i * kLanes + lane]), state,
                     to_f32(wb[i * kLanes + lane]));
        store_f32(out + static_cast<size_t>(i) * D, state);
      }
    }
  }
}

// Once per device and instance, outside any graph capture (the first
// call): allow the largest tiles. A cluster the card cannot schedule is
// refused by cudaLaunchKernelEx itself, and launch() returns that error.
template <typename E, bool kVec>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(linear_scan_kernel<E, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<E>(max_rows<E>())));
  if (err != cudaSuccess) return err;
  ready.fetch_or(bit);
  return cudaSuccess;
}

template <typename E, bool kVec>
int launch(const void* a, const void* b, void* h, int B, int T, int D,
           cudaStream_t s) {
  cudaError_t err = prepare<E, kVec>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the fewest steps a warp that still cover T in one segment, capped
  const int per_block = (T + kCluster - 1) / kCluster;
  const int rows =
      std::min(max_rows<E>(), (per_block + kWarps - 1) / kWarps);
  const int seg_len = kCluster * kWarps * rows;
  const int n_seg = (T + seg_len - 1) / seg_len;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = kCluster;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kLanes - 1) / kLanes, kCluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<E>(rows);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, linear_scan_kernel<E, kVec>,
                           static_cast<const E*>(a), static_cast<const E*>(b),
                           static_cast<E*>(h), T, D, rows, n_seg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies need every row start (and the pointers) 16-byte aligned
template <typename E>
bool vec_ok(const void* a, const void* b, int D) {
  const auto al = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  return al(a) && al(b) && (D * sizeof(E)) % 16 == 0;
}

template <typename E>
int dispatch(const void* a, const void* b, void* h, int B, int T, int D,
             cudaStream_t s) {
  return vec_ok<E>(a, b, D) ? launch<E, true>(a, b, h, B, T, D, s)
                            : launch<E, false>(a, b, h, B, T, D, s);
}

}  // namespace

extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  int dtype, int B, int T, int D,
                                  void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return dispatch<float>(a, b, h, B, T, D, s);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(a, b, h, B, T, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

