// K11: one whole tracking step -- sparse-direct alignment over every
// pyramid level, align2d of the map points, four-round pose-only BA -- in
// one kernel launch: one thread-block cluster per frame.
//
// Replaces ygz_slam_tpu/ops/pallas/track_fused.py::track_step_fused
// (_kernel).  The math is that kernel's, stage by stage:
// 1. Sparse alignment: K3's coarse-to-fine level loop
//    (sparse_align.cuh::mega_levels) on windows fetched at the frame-init
//    pose, each level's Hessian frozen and factored once.
// 2. Align2d: each map point's 8x8 patch aligned inside its 32x32 window
//    (fetched at the frame-init pose with 11 px of slack) from its
//    projection at stage 1's pose, by K4's per-point body (align2d.cuh,
//    which leaves a point's loop once it is frozen) WITHOUT K4's +-1 px
//    step clamp; then the gates, in the kernel: in
//    bounds at margin 6 with z > 0.05 at the start, at margin 5 at the end,
//    err < max_err, drift from the start < 11 px, the landmark's mask.
// 3. Pose-only BA (pose_ba.cuh::pose_ba_cta, K5's body) on stage 2's
//    positions, the accepted points its mask, from stage 1's pose.
// Stages 1 and 3 take the intended step guard (a non-finite step is zero,
// a NaN trial counts as worse), where the JAX kernel keeps `d * finite`
// and accepts unless chi2n > chi2.  The TPU layout is gone: no lane packs,
// no bit-masked roll chains (a window read is an indexed load), no
// iota-identity MXU transposes between the per-point column of stage 2 and
// the lane row of stage 3 (both read one array in device memory), no
// [1, 64] output lane packing.
//
// Bound: neither bytes nor operations.  One frame at N = 200 reads ~1.9 MB
// (windows, patches, Jacobians, the align2d prep; ~0.6 us at 3.35 TB/s)
// and does a few MFLOP; the time is the chain of dependent block
// reductions of stages 1 and 3 (K3's Hessian and ~14 residual passes,
// K5's ~24 reductions) with stage 2's 11 dependent warp-reduced iterations
// per point between them.  The design for Hopper:
//   - K3's and K5's block: 512 threads whatever N is, 128 registers with
//     no spill.  Stage 1 is K3's code on K3's block, so its pose equals
//     K3's bit for bit (the Reducer's order and for_each_pixel's partition
//     depend on blockDim only); stage 3 is K5's code, whose extra warps add
//     +0 partials after the real ones, so its BA equals K5's on the same
//     stage-2 output bit for bit.
//   - A cluster of up to 8 CTAs (the portable maximum, on neighbouring
//     SMs): every CTA runs stage 1 redundantly (bit-identical, so no pose
//     broadcast), then aligns its own contiguous range of map points, a
//     warp per point, so stage 2 spreads over 8 SMs (~2 points per warp at
//     N = 200, where one CTA took ~29).  Results go to device memory; one
//     cluster barrier (release / acquire at cluster scope) publishes them;
//     rank 0 runs stage 3 and the other CTAs leave (no DSMEM is read).
//     The wrapper computes the partition
//     (ops/kernels/track_fused.py::track_partition); common.cuh's
//     launch_cluster makes the launch.
//   - Stage 2 reads its windows from device memory through L1.  Staging
//     them in shared memory with bulk asynchronous copies during stage 1
//     was measured and taken out: the shared memory it takes comes out of
//     L1, and stage 1 then slows by more than stage 2 gains (PERF.md).
#include "align2d.cuh"
#include "pose_ba.cuh"
#include "sparse_align.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct SparseIn {       // stage 1, N points, L levels
  const float* wins;    // [L, N, 16, 16]
  const float* refp;    // [L, N, 16]
  const float* jac;     // [L, N, 16, 6]
  const float* pts;     // [N, 3] in the reference camera
  const float* lvis;    // [L, N] 0/1
  const int* ox;        // [L, N] window origins
  const int* oy;
  int N, L;
};

struct MapIn {          // stage 2, N map points
  const float* wins;    // [N, 32, 32]
  const float* ref;     // [N, 8, 8]
  const float* jx;      // [N, 8, 8]
  const float* jy;      // [N, 8, 8]
  const float* hinv;    // [N, 3, 3]
  const int* ox;        // [N] window origins
  const int* oy;
  const float* pts;     // [N, 3] in the reference camera
  const bool* mask;     // [N]
  int N;
};

struct Caps {
  int sp_iter;
  float sp_eps;
  int a2d_iter;
  float a2d_eps2, a2d_max_err;
  int ba_rounds, ba_iters;
  float ba_eps, chi2_th;
};

constexpr float kInitMargin = 6.f;    // PATCH / 2 + 2
constexpr float kFinalMargin = 5.f;   // PATCH / 2 + 1
constexpr float kMaxDrift = 11.f;     // min(2 * PATCH, CACHE_SLACK)

// Thread 0 of rank 0, when stamps is given: SM clock and global timer at
// mark k (0 start, 1 after stage 1, 2 after the CTA's stage 2, 3 after the
// cluster barrier, 4 end).
__device__ __forceinline__ void mark(unsigned long long* stamps, int k) {
  if (stamps != nullptr && threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    stamps[2 * k] = (unsigned long long)clock64();
    stamps[2 * k + 1] = g;
  }
}

// out [27]: R, t, chi2 of stage 1, chi2 of the last BA round, inlier
// count, then stage 1's R, t.  xy [N2, 2]; per [5, N2]: err, converged,
// inlier (0/1), then BA's mask (bytes) and weights (scratch).
__global__ void __launch_bounds__(kThreads)
track_fused_kernel(SparseIn sp, MapIn mp, const float* __restrict__ pose0,
                   float* __restrict__ out, float* __restrict__ xy, float* __restrict__ per,
                   int H0, int W0, ygz::sparse_align::Cam cam, Caps caps, int per_cta,
                   unsigned long long* __restrict__ stamps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  __shared__ float pose_sp[12];
  __shared__ float ba[13];
  mark(stamps, 0);
  float* err = per;
  float* conv = per + mp.N;
  float* inl = per + 2 * mp.N;
  bool* bamsk = reinterpret_cast<bool*>(per + 3 * mp.N);
  float* wf = per + 4 * mp.N;

  // -- stage 1: sparse-direct alignment, every level (K3's code) ----------
  float R[9], t[3], chi2_sp;
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  ygz::sparse_align::mega_levels(R, t, chi2_sp, sp.wins, sp.refp, sp.jac, sp.pts, sp.lvis,
                                 sp.ox, sp.oy, sp.N, sp.L, H0, W0, cam, caps.sp_iter,
                                 caps.sp_eps, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) pose_sp[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) pose_sp[9 + k] = t[k];
  }
  mark(stamps, 1);

  // -- stage 2: align2d of this CTA's points from stage 1's pose ----------
  // CTA r takes the points [r * per_cta, min(N, (r + 1) * per_cta)).
  const int lane = threadIdx.x & 31;
  const float Wf = (float)W0, Hf = (float)H0;
  const int n0 = min(mp.N, (int)blockIdx.x * per_cta);
  const int n1 = min(mp.N, n0 + per_cta);
  for (int n = n0 + (threadIdx.x >> 5); n < n1; n += kWarps) {   // whole warps
    const float px = mp.pts[3 * n], py = mp.pts[3 * n + 1], pz = mp.pts[3 * n + 2];
    const float x = R[0] * px + R[1] * py + R[2] * pz + t[0];
    const float y = R[3] * px + R[4] * py + R[5] * pz + t[1];
    const float z = R[6] * px + R[7] * py + R[8] * pz + t[2];
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float xn = x / zs, yn = y / zs;
    const float r2 = xn * xn + yn * yn;
    const float radial = 1.f + cam.k1 * r2 + cam.k2 * r2 * r2;
    const float xd = xn * radial + 2.f * cam.p1 * xn * yn + cam.p2 * (r2 + 2.f * xn * xn);
    const float yd = yn * radial + cam.p1 * (r2 + 2.f * yn * yn) + 2.f * cam.p2 * xn * yn;
    const float xi = cam.fx * xd + cam.cx;
    const float yi = cam.fy * yd + cam.cy;
    const ygz::align2d::Result r = ygz::align2d::align_point<false>(
        mp.wins + (size_t)n * 1024, mp.ref + (size_t)n * 64, mp.jx + (size_t)n * 64,
        mp.jy + (size_t)n * 64, mp.hinv + (size_t)n * 9, (float)mp.ox[n], (float)mp.oy[n], xi,
        yi, caps.a2d_iter, caps.a2d_eps2);
    if (lane == 0) {
      const bool inb0 = z > 0.05f && xi >= kInitMargin && xi < Wf - 1.f - kInitMargin &&
                        yi >= kInitMargin && yi < Hf - 1.f - kInitMargin;
      const bool inb1 = r.x >= kFinalMargin && r.x < Wf - 1.f - kFinalMargin &&
                        r.y >= kFinalMargin && r.y < Hf - 1.f - kFinalMargin;
      const float dx = r.x - xi, dy = r.y - yi;
      const bool ok = inb0 && inb1 && r.err < caps.a2d_max_err &&
                      dx * dx + dy * dy < kMaxDrift * kMaxDrift && mp.mask[n];
      xy[2 * n] = r.x;
      xy[2 * n + 1] = r.y;
      err[n] = r.err;
      conv[n] = ok ? 1.f : 0.f;
      bamsk[n] = ok;
    }
  }
  mark(stamps, 2);
  // Every CTA's stage-2 results (device memory) and pose_sp, published to
  // the whole cluster.
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  if (blockIdx.x != 0) return;
  mark(stamps, 3);

  // -- stage 3 (rank 0): pose-only BA on the accepted points (K5's code) --
  pose_ba_cta(Obs{mp.pts, xy, bamsk, cam.fx, cam.fy, cam.cx, cam.cy}, pose_sp, ba, inl, wf,
              mp.N, caps.chi2_th, caps.ba_rounds, caps.ba_iters, caps.ba_eps, red);
  float cnt[1] = {0.f};
  for (int i = threadIdx.x; i < mp.N; i += blockDim.x) cnt[0] += inl[i];   // own rows
  red.sum(cnt);   // its barrier also publishes `ba`, written by thread 0
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = ba[k];
    out[12] = chi2_sp;
    out[13] = ba[12];
    out[14] = cnt[0];
#pragma unroll
    for (int k = 0; k < 12; ++k) out[15 + k] = pose_sp[k];
  }
  mark(stamps, 4);
}

}  // namespace

// One launch of K11 as a single cluster of `cluster` CTAs (1..8), CTA r
// aligning map points [r * per_cta, min(N2, (r + 1) * per_cta)); stamps
// may be null.  Returns the CUDA error of the launch (a refused cluster
// launch is an error: no retry with a smaller cluster).
extern "C" int track_fused_launch(
    const float* wins, const float* refp, const float* jac, const float* pts, const float* lvis,
    const int* ox, const int* oy, int N1, int L, const float* a2_wins, const float* a2_ref,
    const float* a2_jx, const float* a2_jy, const float* a2_hinv, const int* a2_ox,
    const int* a2_oy, const float* a2_pts, const bool* a2_mask, int N2, const float* pose0,
    float* out, float* xy, float* per, int H0, int W0, float fx, float fy, float cx, float cy,
    float k1, float k2, float p1, float p2, int sp_iter, float sp_eps, int a2d_iter,
    float a2d_eps2, float a2d_max_err, int ba_rounds, int ba_iters, float ba_eps,
    float chi2_th, int cluster, int per_cta, unsigned long long* stamps, cudaStream_t stream) {
  const SparseIn sp{wins, refp, jac, pts, lvis, ox, oy, N1, L};
  const MapIn mp{a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, a2_pts, a2_mask, N2};
  const ygz::sparse_align::Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  const Caps caps{sp_iter, sp_eps, a2d_iter, a2d_eps2, a2d_max_err, ba_rounds, ba_iters,
                  ba_eps, chi2_th};
  return (int)ygz::launch_cluster(track_fused_kernel, cluster, per_cta, N2, kThreads, stream,
                                  sp, mp, pose0, out, xy, per, H0, W0, cam, caps, per_cta,
                                  stamps);
}
