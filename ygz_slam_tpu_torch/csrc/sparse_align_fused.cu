// K9: one pyramid level of sparse-direct alignment, its whole Gauss-Newton
// loop in one kernel, in two variants.
//
// Replaces ygz_slam_tpu/ops/pallas/sparse_align_fused.py::level_align_fused
// (_kernel, v1) and ::level_align_fused_v2 (_kernel_v2, v2).  The math is
// the TPU kernels': each point's 16x16 window of the level image fetched
// once at the level-init pose (K1, origins SLACK 5 px up-left of the
// support), its 4x4 patch sampled bilinearly inside the window, a point
// whose support leaves the window masked (not clamped), rollback when chi2
// rises, a stop at max|dx| < eps, at most n_iter iterations, and the right
// retraction T <- T * exp(dx) by the sqrt-free Taylor series with the
// 1.2 rad clamp.
//   v1 recomputes the normal equations (21 H entries, 6 b, chi2) at every
//      trial pose and refactors H each iteration (damped Cholesky, 1e-8 on
//      the diagonal, pivot floor 1e-20); it returns the pose, chi2 and the
//      21 H entries of the last accepted state.
//   v2 freezes H0 at the level-init pose (the level's first pass, at the
//      level-init visibility), factors it once by the JAX v2 rule
//      (cholesky(H0 + 1e-8 I), the identity where that fails or is not
//      finite: common.cuh::chol6_frozen), then runs substitutions only; it
//      returns the pose, chi2 and H0.  The JAX wrapper assembled and
//      factored H0 in XLA because its TPU kernel took the factor; here the
//      kernel does it on K3's level body (sparse_align.cuh::level_loop),
//      which saves the glue's small launches (masks, product, factor).
// The TPU layout (lane-packed windows, 8 bit-masked power-of-two rolls
// standing in for a per-point dynamic slice, [1,1] splat scalars) is gone:
// a lane reads its pixel's 2x2 support with ordinary indexed loads.  The
// JAX loop runs all n_iter iterations with gated updates; here the loop
// breaks once stopped, which gives the same result.  A non-finite or huge
// step becomes zero and a NaN trial counts as worse (the JAX kernels keep
// the NaN step).
//
// Bound: neither bytes nor operations.  One level reads at most ~0.4 MB
// (N=256 windows, patches, Jacobians: well under a microsecond at
// 3.35 TB/s) and does ~1 MFLOP per iteration; the time is the serial chain
// of dependent iterations, each one pass over the points and one
// reduction.
//   v2 runs K3's level body (sparse_align.cuh::level_loop: a pixel per
//      lane, transposed warp reductions whose sums every thread receives
//      in the same order) over v1's cluster below, each pass's sums (29 in
//      the first, 8 in each trial) added across the CTAs by v1's exchange
//      (ClusterReducer); every thread factors H0 and substitutes
//      redundantly in registers (no broadcast, the pose never leaves
//      registers).  One CTA of 512 threads was timed against clusters of
//      2, 4 and 8 CTAs of 256 at N=256: 8 cut a launch by ~17%
//      (PERF.md).
//   v1 spreads each pass over a thread-block cluster of up to 8 CTAs of
//      256 threads (the wrapper's partition: a CTA per 32 points, so one
//      round of the pixel loop per CTA where one CTA took N / 32 rounds).
//      Every CTA holds the pose in registers and runs the same loop over
//      its own contiguous range of points; each pass it block-reduces its
//      29 partial sums (21 H, 6 b, chi2, the pixel count), publishes them
//      in its own shared-memory slot, passes one cluster barrier (release
//      / acquire) and reads every CTA's slot through distributed shared
//      memory, summing them in rank order.  So every thread of every CTA
//      holds the same bits, solves the same system and takes the same
//      accept and stop decisions, with no broadcast and no atomics: a
//      launch repeats bit for bit.  The slots alternate between two
//      buffers, so one barrier per pass suffices, and a last barrier keeps
//      every CTA (and its slots) alive until all have read them.  The
//      loop keeps one state of sums (the last pass's) in registers; thread
//      0 of rank 0 writes each accepted state to the output.  A pass is a
//      chain of latencies (PERF.md: pixel steps ~1.4 us, block reduction
//      0.5, cluster exchange 1.3, solve and retraction 1.3-1.5 at N=256);
//      staging each CTA's share in shared memory (cp.async) cut the pixel
//      steps to ~1.1 us but spilled, and was taken out.
#include <cooperative_groups.h>

#include "sparse_align.cuh"

namespace cg = cooperative_groups;
using namespace ygz;
using namespace ygz::sparse_align;

namespace {

__device__ __forceinline__ Level make_level(const float* wins, const float* refp,
                                            const float* jac, const float* vis, const int* ox,
                                            const int* oy, float scale, int Hl, int Wl) {
  Level lv;
  lv.wins = wins;
  lv.refp = refp;
  lv.jac = jac;
  lv.vis = vis;
  lv.ox = ox;
  lv.oy = oy;
  lv.scale = scale;
  lv.Hl = (float)Hl;
  lv.Wl = (float)Wl;
  return lv;
}

__device__ __forceinline__ float max_abs6(const float dx[6]) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) m = fmaxf(m, fabsf(dx[k]));
  return m;
}

constexpr int kCtaThreads = 256;
constexpr int kSums = 29;            // 21 H, 6 b, chi2 numerator, pixel count

// The cluster's sums of v: each CTA's block sums (identical in all its
// threads) published in its slot slots[flip], one cluster barrier, then
// lane k < kSums of every warp adds sum k of CTAs 0, 1, ..., C - 1 (read
// through distributed shared memory, in rank order) and a shuffle hands
// each lane all of them.  A slot is written again two exchanges later,
// after a barrier that every CTA passes only once it has read it.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], float (*slots)[32], int& flip,
                                            int C) {
  static_assert(K <= 32, "at most 32 values per exchange");
  const int lane = threadIdx.x & 31;
  float* mine = slots[flip];
  flip ^= 1;
  float x = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) x = lane == k ? v[k] : x;
  if (threadIdx.x < K) mine[threadIdx.x] = x;
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int k = lane < K ? lane : 0;
  float tot = *cluster.map_shared_rank(mine + k, 0);
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < C) tot += *cluster.map_shared_rank(mine + k, r);
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = __shfl_sync(kFull, tot, q);
}

// A CTA's block sums (Reducer), then the cluster's (cluster_sum): the sums
// of a K9 v2 pass over a cluster, the same bits in every thread of every
// CTA.
class ClusterReducer {
 public:
  __device__ ClusterReducer(float* smem, float (*slots)[32], int C)
      : red_(smem), slots_(slots), C_(C) {}

  template <int K>
  __device__ __forceinline__ void sum(float (&v)[K]) {
    red_.sum(v);
    cluster_sum(v, slots_, flip_, C_);
  }

 private:
  Reducer red_;
  float (*slots_)[32];
  int flip_ = 0;
  int C_;
};

// Thread 0 of rank 0, when stamps is given: SM clock at mark k of pass p
// (0 after the pixel steps, 1 after the block reduction, 2 after the
// cluster exchange, 3 after the solve and retraction, or the decision of
// the last pass).
__device__ __forceinline__ void v1_mark(unsigned long long* stamps, int p, int k) {
  if (stamps != nullptr && threadIdx.x == 0 && blockIdx.x == 0)
    stamps[4 + 4 * p + k] = (unsigned long long)clock64();
}

__device__ __forceinline__ void v1_time(unsigned long long* stamps, int k) {
  if (stamps != nullptr && threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    stamps[2 * k] = g;
    stamps[2 * k + 1] = (unsigned long long)clock64();
  }
}

// One normal-equation pass at pose (R, t): the cluster's 29 sums in acc,
// the same bits in every thread of every CTA.
__device__ __forceinline__ void v1_pass(const float R[9], const float t[3], const float* pref,
                                        int n, const Cam& cam, const Level& lv,
                                        float (&acc)[kSums], Reducer& red, float (*slots)[32],
                                        int& flip, int C, unsigned long long* stamps, int p) {
  normal_partials(R, t, pref, n, cam, lv, acc);
  v1_mark(stamps, p, 0);
  red.sum(acc);
  v1_mark(stamps, p, 1);
  cluster_sum(acc, slots, flip, C);
  v1_mark(stamps, p, 2);
}

// Thread 0 of rank 0 writes an accepted state: R, t, chi2, H.
__device__ __forceinline__ void v1_accept(float* __restrict__ out, const float R[9],
                                          const float t[3], float chi2,
                                          const float (&acc)[kSums]) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[9 + k] = t[k];
    out[12] = chi2;
#pragma unroll
    for (int k = 0; k < 21; ++k) out[13 + k] = acc[k];
  }
}

// The grid is one cluster of C CTAs; CTA r takes points
// [r * per_cta, min(N, (r + 1) * per_cta)).
__global__ void __launch_bounds__(kCtaThreads)
level_align_v1_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                      const float* __restrict__ jac, const float* __restrict__ pref,
                      const float* __restrict__ vis, const int* __restrict__ ox,
                      const int* __restrict__ oy, const float* __restrict__ pose0,
                      float* __restrict__ out, int N, int Hl, int Wl, float scale, Cam cam,
                      int n_iter, float eps, int per_cta,
                      unsigned long long* __restrict__ stamps) {
  __shared__ float smem[kRedFloats];
  __shared__ float slots[2][32];
  Reducer red(smem);
  v1_time(stamps, 0);
  const int C = gridDim.x;
  const int n0 = min(N, (int)blockIdx.x * per_cta);
  const int n = min(N, n0 + per_cta) - n0;
  const Level lv = make_level(wins + (size_t)n0 * kCwin * kCwin, refp + (size_t)n0 * kNpix,
                              jac + (size_t)n0 * kNpix * 6, vis + n0, ox + n0, oy + n0, scale,
                              Hl, Wl);
  const float* pts = pref + 3 * (size_t)n0;
  int flip = 0;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  // acc: the sums of the last pass, the accepted state's until a trial.
  float acc[kSums];
  int p = 0;                              // passes so far, less one
  v1_pass(R, t, pts, n, cam, lv, acc, red, slots, flip, C, stamps, p);
  float chi2 = acc[27] / fmaxf(acc[28], 1.f);
  v1_accept(out, R, t, chi2, acc);
  for (int it = 0; it < n_iter; ++it) {
    float dx[6], Rn[9], tn[3];
    solve6(acc, acc + 21, dx);
    const bool conv = max_abs6(dx) < eps;
    retract_right(R, t, dx, Rn, tn);
    v1_mark(stamps, p++, 3);
    v1_pass(Rn, tn, pts, n, cam, lv, acc, red, slots, flip, C, stamps, p);
    const float chi2n = acc[27] / fmaxf(acc[28], 1.f);
    if (!(chi2n <= chi2)) break;          // worse (a NaN trial counts as worse): roll back
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = tn[k];
    chi2 = chi2n;
    v1_accept(out, R, t, chi2, acc);
    if (conv) break;
  }
  v1_mark(stamps, p, 3);
  // No CTA leaves (and frees its slots) before every CTA has read them.
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  v1_time(stamps, 1);
}

// K9 v2: level_loop with K9 v2's factor rule on one level.  The grid is
// one cluster of C CTAs; CTA r takes points [r * per_cta, min(N, (r + 1) *
// per_cta)), and each pass's sums (29 in the first, 8 after) are added
// over the cluster.  out [34]: R, t, chi2, then H0's 21 upper-triangular
// sums (the level's first pass, at the level-init pose).
__global__ void __launch_bounds__(kCtaThreads, 1)
level_align_v2_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                      const float* __restrict__ jac, const float* __restrict__ pref,
                      const float* __restrict__ vis, const int* __restrict__ ox,
                      const int* __restrict__ oy, const float* __restrict__ pose0,
                      float* __restrict__ out, int N, int Hl, int Wl, float scale, Cam cam,
                      int n_iter, float eps, int per_cta) {
  __shared__ float smem[kRedFloats];
  __shared__ float slots[2][32];
  ClusterReducer red(smem, slots, gridDim.x);
  const int n0 = min(N, (int)blockIdx.x * per_cta);
  const int n = min(N, n0 + per_cta) - n0;
  const Level lv = make_level(wins + (size_t)n0 * kCwin * kCwin, refp + (size_t)n0 * kNpix,
                              jac + (size_t)n0 * kNpix * 6, vis + n0, ox + n0, oy + n0, scale,
                              Hl, Wl);
  float R[9], t[3], chi2, h[21];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  level_loop<FrozenFactor>(R, t, chi2, h, pref + 3 * (size_t)n0, n, cam, lv, n_iter, eps, red);
  if (threadIdx.x == 0 && blockIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q] = R[q];
#pragma unroll
    for (int q = 0; q < 3; ++q) out[9 + q] = t[q];
    out[12] = chi2;
#pragma unroll
    for (int q = 0; q < 21; ++q) out[13 + q] = h[q];
  }
  // No CTA leaves (and frees its slots) before every CTA has read them.
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

}  // namespace

// One launch of K9 v1 as a single cluster of `cluster` CTAs (1..8), CTA r
// taking points [r * per_cta, min(N, (r + 1) * per_cta)); stamps may be
// null, else int64 [4 + 4 * (n_iter + 1)]: the global timer and SM clock
// at the start and the end, then each pass's four marks.  Returns the CUDA
// error of the launch (a refused cluster launch is an error: no retry with
// a smaller cluster).
extern "C" int level_align_v1_launch(const float* wins, const float* refp, const float* jac,
                                     const float* pref, const float* vis, const int* ox,
                                     const int* oy, const float* pose0, float* out, int N,
                                     int Hl, int Wl, float scale, float fx, float fy, float cx,
                                     float cy, float k1, float k2, float p1, float p2,
                                     int n_iter, float eps, int cluster, int per_cta,
                                     unsigned long long* stamps, cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  return (int)launch_cluster(level_align_v1_kernel, cluster, per_cta, N, kCtaThreads, stream,
                             wins, refp, jac, pref, vis, ox, oy, pose0, out, N, Hl, Wl, scale,
                             cam, n_iter, eps, per_cta, stamps);
}

// One launch of K9 v2 as a single cluster of `cluster` CTAs (1..8), as K9
// v1's.  Returns the CUDA error of the launch.
extern "C" int level_align_v2_launch(const float* wins, const float* refp, const float* jac,
                                     const float* pref, const float* vis, const int* ox,
                                     const int* oy, const float* pose0, float* out, int N,
                                     int Hl, int Wl, float scale, float fx, float fy, float cx,
                                     float cy, float k1, float k2, float p1, float p2,
                                     int n_iter, float eps, int cluster, int per_cta,
                                     cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  return (int)launch_cluster(level_align_v2_kernel, cluster, per_cta, N, kCtaThreads, stream,
                             wins, refp, jac, pref, vis, ox, oy, pose0, out, N, Hl, Wl, scale,
                             cam, n_iter, eps, per_cta);
}
