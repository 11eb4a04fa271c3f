// The trust stage of the Cost-TrustFL round in one launch, for Hopper.
//
// Replaces the two Pallas kernels repro/kernels/trust_score.py:trust_score
// (Eq. 7 + 11 statistics) and repro/kernels/trust_features.py:
// trust_features (the multi-feature pass), and on the round's main path
// also the plain tensor code around them (the reference's
// repro/federated/engine.py:711-752). Three modes:
//
//  * stage (the engine's call): G is the round's wire view (m, ldg), read
//    in place at the last layer's columns [lo, lo + L); refs (K, ldr) at
//    the same columns, row k the own-cloud reference of cloud k, row
//    ref_idx[i] the one of row i. In the engine's order:
//      1. gbar = sum_i w_i g_i / max(sum_i w_i, 1), the rows summed in
//         ascending order, one IEEE add each, one IEEE division (the
//         plain version's bits, so the sign test of f2 agrees);
//      2. per row <g,gbar>, <g,ref>, |g|^2, |ref|^2 and
//         #{d : g_d * gbar_d > 0}; |gbar|^2;
//      3. phi = ReLU(cos(g, gbar)) |g|, cos_ref = ReLU(cos(g, ref));
//      4. med, the median of |g| over rows with w > 0 (the mean of the
//         middle pair, as torch.nanquantile(., 0.5) forms it; NaN when no
//         row delivers); damp = min(1, (med / max(|g|, eps))^2), NaN -> 1;
//         phi <- phi * damp * w;
//      5. with `multi`: the features f0..f3 times w (med NaN or <= 0
//         taken as 1), the (6, 4) separability sums, the Pearson
//         separability, new_sep = rho feat_sep + (1 - rho) sep,
//         feat_w = softmax(new_sep / T), phi <- phi * gate;
//      6. Eq. 8-9: r = phi / sum(phi) (1/n when the sum is <= eps),
//         rep_sel = gamma rep_ema[sel_idx] + (1 - gamma) r where w > 0,
//         else the old value;
//      7. ts = cos_ref * rep_sel * w.
//    Writes phi, ts, rep_sel, |g|, med, gbar and, with `multi`, the
//    features (m, 4), new_sep and feat_w.
//  * score (trust_score's function): gbar given, refs one row, or (K, L)
//    through ref_idx; phi, ts = ReLU(cos(g, ref)) * rep, |g|.
//  * features (trust_features's function): gbar and med given, refs
//    (m, L) one a row or (K, L) through ref_idx; the features times w.
// G is fp32 or bf16 (stage: fp32), refs fp32 or G's type; sums in fp32.
// An index out of range gives NaN in its row (no host sync checks it).
//
// Bound on the H100: the stage reads the (30, 1290) slice of the wire and
// the (3, 1290) references, ~170 KB, ~0.05 us at 3.35 TB/s; a launch
// takes longer (trust_stage_floor below measures it). So the design is
// about latency: one launch for the whole stage where the round used to
// run two kernels and ~35-100 small tensor ops around them, and within it
// as few dependent steps as the math allows.
//
// Design. One thread-block cluster of kCluster = 8 blocks (the portable
// size) of 256 threads. Block r owns the column slice [r W, (r + 1) W),
// W = ceil(L / 8) rounded up to an even width, so a slice of a row starts
// 8-byte aligned whenever the row does (D = 545,098 and lo = 543,808 are
// even: 8-byte copies; otherwise 4-byte ones). Each block
//   1. sends its first rows' index loads, then every copy of its slice of
//      G and of the references at once (cp.async, a warp a row, unrolled)
//      into shared memory, with the per-row inputs beside them; rank 0's
//      gather of rep_ema[sel_idx] goes out in a second copy group that
//      nothing waits for until the combine;
//   2. sums its columns of gbar in row order (stage), then its rows' five
//      partial statistics and |gbar|^2, 8 lanes a row (32 rows at once;
//      the tile pitch is 8 mod 32 floats, so the 4 rows a warp reads fall
//      in 4 bank groups);
//   3. writes them into rank 0's shared memory (distributed shared
//      memory) and arrives at a cluster barrier, 32 rows a round, the
//      slots alternating by round parity. Rank 0 adds the 8 partials of
//      each (row, statistic) in rank order (deterministic, no float
//      atomics) and finishes steps 3-7: the median by rank counting (each
//      warp counts over a slice of the rows, no sort), the separability's
//      15 distinct sums a warp each, the Eq. 8-9 total as a fixed-order
//      reduction.
// What a phase costs here is the chain of dependent instructions of its
// slowest warp, so the work after the exchange is spread over rank 0's
// warps.
// Blocks only write into rank 0's shared memory, before a barrier that
// rank 0 waits on, and never read another block's: once the last barrier
// completes nothing is pending, so a block may exit. A first arrive,
// waited on just before the first remote write, makes sure every block of
// the cluster runs (the write-then-barrier order of linear_scan.cu); it
// orders no data, so it is relaxed. The release arrive of a round
// compiles to a GPU-scope fence, which waits for pending device-memory
// stores: none is pending there (gbar goes out after the last round).
// When the slice, the per-row state and the stash do not fit in shared
// memory (very large m or L) the kernel reads device memory instead
// (kStaged = false): the same steps, slower, any size.
// Everything past the partial sums is written with _rn intrinsics, so
// nvcc contracts nothing into an fma that the plain version rounds twice.
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum : int { kModeScore = 0, kModeFeatures = 1, kModeStage = 2 };
enum : int { kRefSingle = 0, kRefRows = 1, kRefIndexed = 2 };

constexpr int kCluster = 8;       // blocks of the clustered launch
constexpr int kThreads = 256;     // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // rows a partial exchange
constexpr int kStats = 5;         // <g,gbar>, <g,ref>, |g|^2, |ref|^2, #agree
constexpr int kFeat = 4;
// rank 0's per-row stash: |g|, phi, cos_ref, #agree, w, old reputation,
// then the features
constexpr int kStash = 6 + kFeat;
constexpr size_t kSmemBudget = 200 * 1024;
// repro_torch/core/features.py
constexpr float kRho = 0.5f;      // FEAT_SEP_RHO
constexpr float kTemp = 0.2f;     // WEIGHT_TEMP
constexpr float kBetaMax = 0.3f;  // BETA_MAX
constexpr int kAnchor = 1;        // ANCHOR_FEATURE
constexpr int kConsensus = 0;     // CONSENSUS_FEATURE

struct Params {
  const void* g;              // row i, column c at g + i * ldg + lo + c
  long long ldg;
  const void* ref;            // row k at ref + k * ldr + lo
  long long ldr;
  const long long* ref_idx;   // (m,) row -> ref row (kRefIndexed)
  int ref_mode, n_ref;
  int lo, L, m;
  int mode, multi;
  const float* w;             // (m,) features, stage
  const float* gbar_in;       // (L,) score, features
  const float* med_in;        // () features
  const float* rep;           // score: (m,) reputation; stage: (n_rep,)
  const long long* sel_idx;   // (m,) stage
  long long n_rep;
  const float* feat_sep;      // (4,) stage with multi
  float gamma, one_minus_gamma, inv_n, eps;
  float *phi, *ts, *norms, *rep_sel, *med, *gbar, *feats, *new_sep, *feat_w;
  float* work;                // (m, kStash) device scratch (kStaged = false)
  // shared-memory layout (plan() fills it in)
  int width, pitch, chunk;
  unsigned off_gbar, off_rows, off_stash, off_tile_g, off_tile_r;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// barrier.cluster: the release arrive and the acquire wait order the
// partials; the relaxed arrive only says that this block runs
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest n commit groups of this thread have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// One element: a 4-byte copy in flight, or a plain load (2-byte bf16).
template <typename T>
__device__ __forceinline__ void copy_one(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    cp_async<4>(dst, src);
  else
    *dst = *src;
}

// Starts the copy of rows x nc elements (row pitch ld) into dst (row
// pitch `pitch`, even), a warp a row, every copy in flight at once.
// kVec: every row start is pair-aligned, so whole pairs move as one copy.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, const T* src,
                                          long long ld, int rows, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int i = warp; i < rows; i += kWarps) {
    const T* s = src + i * ld;
    T* d = dst + i * pitch;
    if constexpr (kVec) {
#pragma unroll 4
      for (int k = 2 * lane; k + 1 < nc; k += 64)
        cp_async<2 * sizeof(T)>(d + k, s + k);
      if ((nc & 1) && lane == 0) copy_one(d + nc - 1, s + nc - 1);
    } else {
#pragma unroll 4
      for (int k = lane; k < nc; k += 32) copy_one(d + k, s + k);
    }
  }
}

// The total of v over the block, in every thread. Only threads below
// `active` may hold non-zero values (warps past it skip their shuffles).
// The warps' sums are added in warp order, so the total does not depend
// on timing. `red` ([warps]) belongs to one call site.
__device__ __forceinline__ float block_total(float v, float* red,
                                             int active) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp * 32 < active) v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int warps = min(kWarps, (active + 31) / 32);
  float acc = 0.f;
  for (int k = 0; k < warps; ++k) acc = __fadd_rn(acc, red[k]);
  return acc;
}

// The reference row of row i, or -1 when its index is out of range.
__device__ __forceinline__ int ref_row(const Params& p, int i) {
  if (p.ref_mode == kRefSingle) return 0;
  if (p.ref_mode == kRefRows) return i;
  const long long k = p.ref_idx[i];
  return (k >= 0 && k < p.n_ref) ? static_cast<int>(k) : -1;
}

// Row i's reputation: score mode its input; stage rep[sel_idx[i]] (NaN
// when the index is out of range).
__device__ __forceinline__ float row_rep(const Params& p, int i) {
  if (p.mode == kModeScore) return p.rep[i];
  if (p.mode != kModeStage) return 0.f;
  const long long s = p.sel_idx[i];
  return (s >= 0 && s < p.n_rep) ? p.rep[s] : nanf("");
}

// trust_features.cu's finalize: f0..f3 of one row times w.
__device__ __forceinline__ void row_features(float norm, float f1,
                                             float agree, int L, float med,
                                             float wi, float eps,
                                             float (&f)[kFeat]) {
  const float f0 = 1.f / (1.f + fabsf(logf(fmaxf(norm, eps) / med)));
  const float f2 = agree / static_cast<float>(L);
  const float ratio = fmaxf(norm, eps) / med;
  const float x = f1 * fminf(ratio, 1.f / ratio);
  const float f3 = x / (1.f + x);
  f[0] = f0 * wi;
  f[1] = f1 * wi;
  f[2] = f2 * wi;
  f[3] = f3 * wi;
}

__device__ __forceinline__ float sanitize_med(float med) {
  return (isnan(med) || !(med > 0.f)) ? 1.f : med;
}

// One term of the separability sums (features.separability_sums) of a
// row: q = 0: w; 1: w a; 2: w a a; 3 + k: w f_k; 7 + k: w f_k f_k;
// 11 + k: w f_k a (a = f_1, the anchor), products in the plain order.
constexpr int kSepTerms = 3 + 3 * kFeat;
__device__ __forceinline__ float sep_term(const float* st, int q) {
  const float w = st[4], a = st[6 + kAnchor];
  if (q == 0) return w;
  const float wa = __fmul_rn(w, a);
  if (q == 1) return wa;
  if (q == 2) return __fmul_rn(wa, a);
  const int k = (q - 3) % kFeat;
  const float f = st[6 + k], wf = __fmul_rn(w, f);
  if (q < 3 + kFeat) return wf;
  return __fmul_rn(wf, q < 3 + 2 * kFeat ? f : a);
}

// Rank 0, once every row's statistics are in `stash` ([m][kStash]):
// steps 4-7, spread over the block's warps (one warp's chain of dependent
// instructions is what a phase costs here).
__device__ __forceinline__ void finish_stage(const Params& p, float* stash) {
  __shared__ int s_rank[kWarps][32][2];   // a warp's (less, eq) per row
  __shared__ int s_valid[kWarps];
  __shared__ float s_sums[kSepTerms];
  __shared__ float s_ns[kFeat], s_fw[kFeat];
  __shared__ float red_tot[kWarps];
  __shared__ float s_lo, s_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, m = p.m;
  const int active = min(m, kThreads);
  const float eps = p.eps;

  // 4. the median of the valid norms: a valid row is the order statistic
  // k when k lies in [less, less + eq) of its rank among them; each warp
  // counts over its slice of the rows, warp 0 adds the slices in order
  const int per = (m + kWarps - 1) / kWarps;
  const int j0 = min(m, warp * per), j1 = min(m, j0 + per);
  int n_valid = 0;
  for (int r0 = 0; r0 < m; r0 += 32) {
    const int i = r0 + lane;
    const float x = i < m ? stash[i * kStash] : 0.f;
    int less = 0, eq = 0, nv = 0;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const int v = stash[j * kStash + 4] > 0.f;
      const float y = stash[j * kStash];
      nv += v;
      less += v & (y < x);
      eq += v & (y == x);
    }
    s_rank[warp][lane][0] = less;
    s_rank[warp][lane][1] = eq;
    if (r0 == 0 && lane == 0) s_valid[warp] = nv;
    __syncthreads();
    if (warp == 0) {
      int n = 0, l = 0, e = 0;
      for (int k = 0; k < kWarps; ++k) {
        n += s_valid[k];
        l += s_rank[k][lane][0];
        e += s_rank[k][lane][1];
      }
      n_valid = n;
      if (i < m && stash[i * kStash + 4] > 0.f) {
        const int k_lo = (n - 1) / 2, k_hi = n / 2;
        if (l <= k_lo && k_lo < l + e) s_lo = x;   // ties write one value
        if (l <= k_hi && k_hi < l + e) s_hi = x;
      }
    }
    __syncthreads();
  }
  if (warp == 0 && lane == 0) s_valid[0] = n_valid;
  __syncthreads();
  const int cnt = s_valid[0];
  float med = nanf("");
  if (cnt > 0)   // torch.lerp(lo, hi, 0.5) for an even count
    med = (cnt & 1) ? s_lo
                    : __fsub_rn(s_hi, __fmul_rn(__fsub_rn(s_hi, s_lo), 0.5f));
  const float med_f = sanitize_med(med);

  // damp and features, a thread a row
  for (int i = tid; i < m; i += kThreads) {
    float* st = stash + i * kStash;
    const float wi = st[4], norm = st[0];
    const float q = __fdiv_rn(med, fmaxf(norm, eps));
    const float damp = fminf(__fmul_rn(q, q), 1.f);   // NaN -> 1
    st[1] = __fmul_rn(__fmul_rn(st[1], damp), wi);
    if (p.multi) {
      float f[kFeat];
      row_features(norm, st[2], st[3], p.L, med_f, wi, eps, f);
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        st[6 + k] = f[k];
        p.feats[i * kFeat + k] = f[k];
      }
    }
  }
  __syncthreads();

  // 5. separability: the distinct sums a warp each (rows in lane order,
  // then a butterfly); the Pearson separability and its EMA a thread a
  // feature; the softmax weights; the gate strength
  float fw[kFeat] = {0.f, 0.f, 0.f, 0.f};
  float beta = 0.f;
  if (p.multi) {
    for (int q = warp; q < kSepTerms; q += kWarps) {
      float acc = 0.f;
      for (int i = lane; i < m; i += 32)
        acc = __fadd_rn(acc, sep_term(stash + i * kStash, q));
      acc = warp_sum(acc);
      if (lane == 0) s_sums[q] = acc;
    }
    __syncthreads();
    if (tid < kFeat) {
      const int k = tid;
      // five IEEE divisions by sw, as the plain version forms them
      const float sw = fmaxf(s_sums[0], eps);
      const float mean_f = __fdiv_rn(s_sums[3 + k], sw);
      const float mean_r = __fdiv_rn(s_sums[1], sw);
      const float var_f = fmaxf(__fsub_rn(__fdiv_rn(s_sums[7 + k], sw),
                                          __fmul_rn(mean_f, mean_f)), 0.f);
      const float var_r = fmaxf(__fsub_rn(__fdiv_rn(s_sums[2], sw),
                                          __fmul_rn(mean_r, mean_r)), 0.f);
      const float cov = __fsub_rn(__fdiv_rn(s_sums[11 + k], sw),
                                  __fmul_rn(mean_f, mean_r));
      float corr = __fdiv_rn(cov, __fsqrt_rn(fmaxf(__fmul_rn(var_f, var_r),
                                                   __fmul_rn(eps, eps))));
      if (!(var_f > eps && var_r > eps)) corr = 0.f;
      const float sep = fminf(fmaxf(corr, 0.f), 1.f);
      const float ns = __fadd_rn(__fmul_rn(kRho, p.feat_sep[k]),
                                 __fmul_rn(1.f - kRho, sep));
      s_ns[k] = ns;
      p.new_sep[k] = ns;
    }
    __syncthreads();
    if (tid < kFeat) {   // softmax(new_sep / T), each thread its weight
      float z[kFeat], top = -INFINITY, den = 0.f;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        z[k] = __fmul_rn(s_ns[k], 1.f / kTemp);   // 1 / 0.2f rounds to 5
        top = fmaxf(top, z[k]);
      }
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        z[k] = expf(__fsub_rn(z[k], top));
        den = __fadd_rn(den, z[k]);
      }
      const float inv_den = __fdiv_rn(1.f, den);
      float mine = 0.f;
#pragma unroll
      for (int k = 0; k < kFeat; ++k)
        if (k == tid) mine = __fmul_rn(z[k], inv_den);
      s_fw[tid] = mine;
      p.feat_w[tid] = mine;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFeat; ++k) fw[k] = s_fw[k];
    beta = __fmul_rn(kBetaMax, fminf(fmaxf(s_ns[kConsensus], 0.f), 1.f));
  }

  // the gate, then the round's total of phi
  float tot = 0.f;
  for (int i = tid; i < m; i += kThreads) {
    float* st = stash + i * kStash;
    float phi = st[1];
    if (p.multi) {
      float mix = 0.f;
#pragma unroll
      for (int k = 0; k < kFeat; ++k)
        mix = __fadd_rn(mix, __fmul_rn(st[6 + k], fw[k]));
      phi = __fmul_rn(phi,
                      __fadd_rn(__fsub_rn(1.f, beta), __fmul_rn(beta, mix)));
      st[1] = phi;
    }
    tot = __fadd_rn(tot, phi);
  }
  // m <= 32: every row is in warp 0, whose lanes need the total
  const float total = m <= 32 ? warp_sum(tot)
                              : block_total(tot, red_tot, active);

  // 6-7. Eq. 8-9 and Eq. 11's trust
  for (int i = tid; i < m; i += kThreads) {
    const float* st = stash + i * kStash;
    const float wi = st[4], phi = st[1], old = st[5];
    const float r =
        total > eps ? __fdiv_rn(phi, fmaxf(total, eps)) : p.inv_n;
    const float rs =
        wi > 0.f ? __fadd_rn(__fmul_rn(p.gamma, old),
                             __fmul_rn(p.one_minus_gamma, r))
                 : old;
    p.phi[i] = phi;
    p.rep_sel[i] = rs;
    p.ts[i] = __fmul_rn(__fmul_rn(st[2], rs), wi);
    p.norms[i] = st[0];
  }
  if (tid == 0) *p.med = med;
}

// kStaged: the slice, the per-row inputs and the stash live in shared
// memory (the pointers below derive from it, so every access is an LDS
// with 32-bit offsets); otherwise the kernel reads device memory.
template <typename TG, typename TR, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads)
trust_stage_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Idx = std::conditional_t<kStaged, int, long long>;
  constexpr int kGroup = kThreads / kChunk;   // lanes that share a row
  static_assert(kGroup > kStats && kGroup <= 32, "a row's lanes");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int m = p.m, width = p.width, chunk = p.chunk;
  const int c0 = rank * width;
  const int nc = max(0, min(p.L, c0 + width) - c0);
  const float eps = p.eps;
  const bool stage = p.mode == kModeStage;
  // [2][kCluster][chunk][kStats] partials by round parity, then
  // [kCluster] |gbar|^2
  float* const slots = reinterpret_cast<float*>(smem);
  __shared__ float s_tot[kChunk * kStats];   // rank 0: a round's totals
  float* const glob = slots + 2 * kCluster * chunk * kStats;

  const TG* gv = static_cast<const TG*>(p.g) + p.lo + c0;
  const TR* rv = static_cast<const TR*>(p.ref) + p.lo + c0;
  Idx gp = static_cast<Idx>(p.ldg), rp = static_cast<Idx>(p.ldr);
  float* gb;          // this block's columns of gbar
  float* s_w = nullptr;
  int* s_ref = nullptr;
  float* s_rep = nullptr;
  float* stash;
  if constexpr (kStaged) {
    gb = reinterpret_cast<float*>(smem + p.off_gbar);
    s_w = reinterpret_cast<float*>(smem + p.off_rows);
    s_ref = reinterpret_cast<int*>(s_w + m);
    s_rep = reinterpret_cast<float*>(s_ref + m);
    stash = reinterpret_cast<float*>(smem + p.off_stash);
    TG* tg = reinterpret_cast<TG*>(smem + p.off_tile_g);
    TR* tr = reinterpret_cast<TR*>(smem + p.off_tile_r);
    // 1. the first rows' indices go out first, then every copy of the
    // slice (group 0), then the rows' inputs
    const bool mine = tid < m;
    const bool gather = rank == 0 && p.mode != kModeFeatures;
    const long long ref_raw =
        mine && p.ref_mode == kRefIndexed ? p.ref_idx[tid] : 0;
    const long long sel_raw = mine && gather && stage ? p.sel_idx[tid] : tid;
    copy_rows<TG, kVec>(tg, p.pitch, gv, p.ldg, m, nc);
    copy_rows<TR, kVec>(tr, p.pitch, rv, p.ldr, p.n_ref, nc);
    if (!stage)
      for (int j = tid; j < nc; j += kThreads)
        cp_async<4>(gb + j, p.gbar_in + c0 + j);
    if (p.w)
      for (int i = tid; i < m; i += kThreads) cp_async<4>(s_w + i, p.w + i);
    cp_async_commit();
    // rank 0's reputations (group 1: waited for before the combine)
    const long long n_rep = stage ? p.n_rep : m;
    const auto rep_to = [&](int i, long long s) {
      if (s >= 0 && s < n_rep)
        cp_async<4>(s_rep + i, p.rep + s);
      else
        s_rep[i] = nanf("");
    };
    if (mine) {
      s_ref[tid] = p.ref_mode == kRefIndexed
                       ? (ref_raw >= 0 && ref_raw < p.n_ref
                              ? static_cast<int>(ref_raw) : -1)
                       : (p.ref_mode == kRefRows ? tid : 0);
      if (gather) rep_to(tid, sel_raw);
    }
    for (int i = tid + kThreads; i < m; i += kThreads) {
      s_ref[i] = ref_row(p, i);
      if (gather) rep_to(i, stage ? p.sel_idx[i] : i);
    }
    cp_async_commit();
    gv = tg;
    rv = tr;
    gp = rp = p.pitch;
    cp_async_wait<1>();
  } else {
    gb = stage ? p.gbar + c0 : const_cast<float*>(p.gbar_in) + c0;
    stash = p.work;
  }
  const auto w_at = [&](int i) -> float {
    if constexpr (kStaged) return s_w[i];
    else return p.w[i];
  };
  const auto ref_at = [&](int i) -> int {
    if constexpr (kStaged) return s_ref[i];
    else return ref_row(p, i);
  };
  const float med_in = p.mode == kModeFeatures ? sanitize_med(*p.med_in) : 1.f;
  cluster_arrive_relaxed();   // this block runs: others may write into rank 0
  __syncthreads();

  // 2. gbar of the slice, rows in ascending order (stage)
  if (stage) {
    for (int j = tid; j < nc; j += kThreads) {
      const TG* col = gv + j;
      float acc = 0.f, sw = 0.f;
      for (int i0 = 0; i0 < m; i0 += 8) {
        float wv[8], xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = min(i0 + u, m - 1);
          wv[u] = w_at(i);
          xv[u] = to_f32(col[i * gp]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u < m) {
            acc = __fadd_rn(acc, __fmul_rn(wv[u], xv[u]));
            sw = __fadd_rn(sw, wv[u]);
          }
        }
      }
      gb[j] = __fdiv_rn(acc, fmaxf(sw, 1.f));
    }
    __syncthreads();
  }

  // per-row partials, exchanged 32 rows a round
  float nbar = 0.f;
  for (int c = 0; c * chunk < m; ++c) {
    const int row0 = c * chunk, n_rows = min(chunk, m - row0);
    float* const slot = slots + (c & 1) * kCluster * chunk * kStats;
    {
      const int ii = tid / kGroup, q = tid % kGroup;   // a group a row
      const bool has = ii < n_rows;
      const int i = row0 + min(ii, n_rows - 1);
      const TG* gr = gv + i * gp;
      const TR* rr = rv + max(ref_at(i), 0) * rp;
      // every group also sums |gbar|^2 over the slice; group 0 reports it
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, bb = 0.f;
      int agree = 0;
#pragma unroll 4
      for (int j = has ? q : nc; j < nc; j += kGroup) {
        const float x = to_f32(gr[j]);
        const float b = gb[j];
        const float r = to_f32(rr[j]);
        s0 = fmaf(x, b, s0);
        s1 = fmaf(x, r, s1);
        s2 = fmaf(x, x, s2);
        s3 = fmaf(r, r, s3);
        bb = fmaf(b, b, bb);
        // the product's sign, as the reference tests it (an underflow
        // to 0 is a disagreement there too)
        agree += __fmul_rn(x, b) > 0.f;
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        s3 += __shfl_xor_sync(0xffffffffu, s3, off);
        agree += __shfl_xor_sync(0xffffffffu, agree, off);
        bb += __shfl_xor_sync(0xffffffffu, bb, off);
      }
      if (c == 0) {
        cluster_wait();   // every block of the cluster runs
        if (ii == 0 && q == kStats) *cluster.map_shared_rank(glob + rank, 0) = bb;
      }
      const float v = q == 0   ? s0
                      : q == 1 ? s1
                      : q == 2 ? s2
                      : q == 3 ? s3
                               : static_cast<float>(agree);
      if (has && q < kStats)
        *cluster.map_shared_rank(slot + (rank * chunk + ii) * kStats + q,
                                 0) = v;
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0) continue;
    if (c == 0) {
      float t = 0.f;
      for (int r = 0; r < kCluster; ++r) t = __fadd_rn(t, glob[r]);
      nbar = sqrtf(fmaxf(t, 0.f));
      if constexpr (kStaged) {   // the reputations have landed
        cp_async_wait<0>();
        __syncthreads();
      }
    }
    // 3. rank 0: the rows' totals in rank order, a thread a (row,
    // statistic), then per row
    for (int t = tid; t < n_rows * kStats; t += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        acc = __fadd_rn(acc, slot[r * chunk * kStats + t]);
      s_tot[t] = acc;
    }
    __syncthreads();
    for (int ii = tid; ii < n_rows; ii += kThreads) {
      const int i = row0 + ii;
      float v[kStats];
#pragma unroll
      for (int q = 0; q < kStats; ++q) v[q] = s_tot[ii * kStats + q];
      const float norm = sqrtf(fmaxf(v[2], 0.f));
      const float nref = sqrtf(fmaxf(v[3], 0.f));
      float cos_ref = fmaxf(v[1] / fmaxf(norm * nref, eps), 0.f);
      if (ref_at(i) < 0) cos_ref = nanf("");
      const float phi0 = fmaxf(v[0] / fmaxf(norm * nbar, eps), 0.f) * norm;
      float old;
      if constexpr (kStaged) old = s_rep[i];
      else old = row_rep(p, i);
      if (p.mode == kModeScore) {
        p.phi[i] = phi0;
        p.ts[i] = cos_ref * old;
        p.norms[i] = norm;
      } else if (p.mode == kModeFeatures) {
        float f[kFeat];
        row_features(norm, cos_ref, v[4], p.L, med_in, w_at(i), eps, f);
#pragma unroll
        for (int q = 0; q < kFeat; ++q) p.feats[i * kFeat + q] = f[q];
      } else {
        float* st = stash + i * kStash;
        st[0] = norm;
        st[1] = phi0;
        st[2] = cos_ref;
        st[3] = v[4];
        st[4] = w_at(i);
        st[5] = old;
      }
    }
  }
  if constexpr (kStaged) {   // gbar out, now that no round waits on it
    if (stage)
      for (int j = tid; j < nc; j += kThreads) p.gbar[c0 + j] = gb[j];
  }
  if (rank == 0 && stage) {
    __syncthreads();
    finish_stage(p, stash);
  }
}

// Once per device and instance, outside any graph capture (the first
// call): allow the shared-memory budget. A cluster the card cannot
// schedule is refused by cudaLaunchKernelEx itself.
template <typename TG, typename TR, bool kVec, bool kStaged>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      trust_stage_kernel<TG, TR, kVec, kStaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBudget));
  if (err != cudaSuccess) return err;
  ready.fetch_or(bit);
  return cudaSuccess;
}

// Lays out shared memory: the partial slots; then, when everything fits
// (staged), gbar's slice, the per-row inputs, rank 0's stash and the
// tiles. Returns the bytes, and whether the staged layout fits.
template <typename TG, typename TR>
size_t plan(Params& p, bool& staged) {
  const int per = (p.L + kCluster - 1) / kCluster;
  p.width = per + (per & 1);
  // 8 mod 32 floats: the 4 rows a warp reads at once hit 4 bank groups
  p.pitch = p.width + ((8 - p.width) & 31);
  p.chunk = std::min(p.m, kChunk);
  size_t off =
      align16(sizeof(float) * (2 * kCluster * p.chunk * kStats + kCluster));
  const size_t base = off;
  const auto place = [&](size_t bytes) {
    const auto at = static_cast<unsigned>(off);
    off += align16(bytes);
    return at;
  };
  const size_t m = static_cast<size_t>(p.m);
  p.off_gbar = place(sizeof(float) * p.pitch);
  p.off_rows = place(3 * sizeof(float) * m);
  p.off_stash = place(p.mode == kModeStage ? sizeof(float) * kStash * m : 0);
  p.off_tile_g = place(sizeof(TG) * m * p.pitch);
  p.off_tile_r = place(sizeof(TR) * static_cast<size_t>(p.n_ref) * p.pitch);
  staged = off <= kSmemBudget;
  return staged ? off : base;
}

template <typename TG, typename TR, bool kVec, bool kStaged>
int launch(const Params& p, size_t smem_bytes, cudaStream_t s) {
  cudaError_t err = prepare<TG, TR, kVec, kStaged>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, trust_stage_kernel<TG, TR, kVec, kStaged>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// pair copies need every row start (and both pointers) pair-aligned
template <typename TG, typename TR>
bool vec_ok(const Params& p) {
  const auto al = [](const void* q, size_t b) {
    return reinterpret_cast<size_t>(q) % b == 0;
  };
  return al(p.g, 2 * sizeof(TG)) && al(p.ref, 2 * sizeof(TR)) &&
         p.ldg % 2 == 0 && (p.ref_mode == kRefSingle || p.ldr % 2 == 0) &&
         p.lo % 2 == 0;
}

template <typename TG, typename TR>
int dispatch(Params p, cudaStream_t s) {
  bool staged = false;
  const size_t bytes = plan<TG, TR>(p, staged);
  if (!staged) return launch<TG, TR, false, false>(p, bytes, s);
  return vec_ok<TG, TR>(p) ? launch<TG, TR, true, true>(p, bytes, s)
                           : launch<TG, TR, false, true>(p, bytes, s);
}

__global__ void trust_stage_floor_kernel() {}

}  // namespace

// One launch of the trust stage (mode 2) or of a standalone mode (0:
// trust_score, 1: trust_features). dtype codes as in common.cuh; the
// kernel reads columns [lo, lo + L) of m rows of G (row pitch ldg) and of
// the reference rows (pitch ldr), in one 8-block cluster. Returns a
// cudaError_t.
extern "C" int trust_stage_launch(
    int mode, int multi, int g_dtype, int ref_dtype, const void* g,
    long long ldg, const void* ref, long long ldr, int ref_mode,
    const long long* ref_idx, int n_ref, int lo, int L, int m,
    const float* w, const float* gbar_in, const float* med_in,
    const float* rep, const long long* sel_idx, long long n_rep,
    const float* feat_sep, float gamma, float one_minus_gamma, float inv_n,
    float eps, float* phi, float* ts, float* norms, float* rep_sel,
    float* med, float* gbar, float* feats, float* new_sep, float* feat_w,
    float* work, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0 || lo < 0 || n_ref <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.g = g;
  p.ldg = ldg;
  p.ref = ref;
  p.ldr = ldr;
  p.ref_idx = ref_idx;
  p.ref_mode = ref_mode;
  p.n_ref = n_ref;
  p.lo = lo;
  p.L = L;
  p.m = m;
  p.mode = mode;
  p.multi = multi;
  p.w = w;
  p.gbar_in = gbar_in;
  p.med_in = med_in;
  p.rep = rep;
  p.sel_idx = sel_idx;
  p.n_rep = n_rep;
  p.feat_sep = feat_sep;
  p.gamma = gamma;
  p.one_minus_gamma = one_minus_gamma;
  p.inv_n = inv_n;
  p.eps = eps;
  p.phi = phi;
  p.ts = ts;
  p.norms = norms;
  p.rep_sel = rep_sel;
  p.med = med;
  p.gbar = gbar;
  p.feats = feats;
  p.new_sep = new_sep;
  p.feat_w = feat_w;
  p.work = work;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == DTYPE_F32 && ref_dtype == DTYPE_F32)
    return dispatch<float, float>(p, s);
  if (g_dtype == DTYPE_BF16 && ref_dtype == DTYPE_F32)
    return dispatch<__nv_bfloat16, float>(p, s);
  if (g_dtype == DTYPE_BF16 && ref_dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel on the stage's grid (8 blocks of 256 threads), launched
// plain or as one 8-block cluster: the launch floor of this card.
extern "C" int trust_stage_floor_launch(int cluster, void* stream) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster ? &attr : nullptr;
  cfg.numAttrs = cluster ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, trust_stage_floor_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
