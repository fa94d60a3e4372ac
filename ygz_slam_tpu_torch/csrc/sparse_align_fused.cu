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
//   v2 runs substitutions only, against the Cholesky factor of the frozen
//      H0 that the caller computes (ops/kernels/sparse_align_fused.py); it
//      returns the pose and chi2.
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
// of dependent iterations, each one pass over the points and one block
// reduction.  So one CTA of 512 threads runs the chain on K3's per-pass
// body (sparse_align.cuh: a pixel per lane, transposed warp reductions
// whose sums every thread receives in the same order), and each thread
// then solves the 6x6 system redundantly in registers (no broadcast, the
// pose never leaves registers).
#include "sparse_align.cuh"

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

constexpr int kThreads = 512;

__device__ __forceinline__ float max_abs6(const float dx[6]) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) m = fmaxf(m, fabsf(dx[k]));
  return m;
}

__global__ void __launch_bounds__(kThreads)
level_align_v1_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                      const float* __restrict__ jac, const float* __restrict__ pref,
                      const float* __restrict__ vis, const int* __restrict__ ox,
                      const int* __restrict__ oy, const float* __restrict__ pose0,
                      float* __restrict__ out, int N, int Hl, int Wl, float scale, Cam cam,
                      int n_iter, float eps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  const Level lv = make_level(wins, refp, jac, vis, ox, oy, scale, Hl, Wl);
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  float h[21], bv[6], chi2;
  normal_eqs(R, t, pref, N, cam, lv, h, bv, chi2, red);
  bool stop = false;
  for (int it = 0; !stop && it < n_iter; ++it) {
    float dx[6];
    solve6(h, bv, dx);
    const bool conv = max_abs6(dx) < eps;
    float Rn[9], tn[3], hn[21], bn[6], chi2n;
    retract_right(R, t, dx, Rn, tn);
    normal_eqs(Rn, tn, pref, N, cam, lv, hn, bn, chi2n, red);
    const bool worse = !(chi2n <= chi2);  // a NaN trial counts as worse
    if (!worse) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = tn[k];
#pragma unroll
      for (int k = 0; k < 21; ++k) h[k] = hn[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) bv[k] = bn[k];
      chi2 = chi2n;
    }
    stop = worse || conv;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[9 + k] = t[k];
    out[12] = chi2;
#pragma unroll
    for (int k = 0; k < 21; ++k) out[13 + k] = h[k];
  }
}

__global__ void __launch_bounds__(kThreads)
level_align_v2_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                      const float* __restrict__ jac, const float* __restrict__ pref,
                      const float* __restrict__ vis, const int* __restrict__ ox,
                      const int* __restrict__ oy, const float* __restrict__ pose0,
                      const float* __restrict__ lfac, float* __restrict__ out, int N, int Hl,
                      int Wl, float scale, Cam cam, int n_iter, float eps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  const Level lv = make_level(wins, refp, jac, vis, ox, oy, scale, Hl, Wl);
  float R[9], t[3], Lc[6][6];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  // The factor's 21 lower-triangular entries, row-major (tril_indices(6)).
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int q = 0; q <= i; ++q) Lc[i][q] = lfac[k++];
  float bv[6], chi2;
  residual_pass(R, t, pref, N, cam, lv, bv, chi2, red);
  bool stop = false;
  for (int it = 0; !stop && it < n_iter; ++it) {
    float dx[6];
    subst6(Lc, bv, dx);
    const bool conv = max_abs6(dx) < eps;
    float Rn[9], tn[3], bn[6], chi2n;
    retract_right(R, t, dx, Rn, tn);
    residual_pass(Rn, tn, pref, N, cam, lv, bn, chi2n, red);
    const bool worse = !(chi2n <= chi2);  // a NaN trial counts as worse
    if (!worse) {
#pragma unroll
      for (int q = 0; q < 9; ++q) R[q] = Rn[q];
#pragma unroll
      for (int q = 0; q < 3; ++q) t[q] = tn[q];
#pragma unroll
      for (int q = 0; q < 6; ++q) bv[q] = bn[q];
      chi2 = chi2n;
    }
    stop = worse || conv;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) out[q] = R[q];
#pragma unroll
    for (int q = 0; q < 3; ++q) out[9 + q] = t[q];
    out[12] = chi2;
  }
}

}  // namespace

extern "C" int level_align_v1_launch(const float* wins, const float* refp, const float* jac,
                                     const float* pref, const float* vis, const int* ox,
                                     const int* oy, const float* pose0, float* out, int N,
                                     int Hl, int Wl, float scale, float fx, float fy, float cx,
                                     float cy, float k1, float k2, float p1, float p2,
                                     int n_iter, float eps, cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  level_align_v1_kernel<<<1, kThreads, 0, stream>>>(wins, refp, jac, pref, vis, ox, oy, pose0,
                                                   out, N, Hl, Wl, scale, cam, n_iter, eps);
  return (int)cudaGetLastError();
}

extern "C" int level_align_v2_launch(const float* wins, const float* refp, const float* jac,
                                     const float* pref, const float* vis, const int* ox,
                                     const int* oy, const float* pose0, const float* lfac,
                                     float* out, int N, int Hl, int Wl, float scale, float fx,
                                     float fy, float cx, float cy, float k1, float k2,
                                     float p1, float p2, int n_iter, float eps,
                                     cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  level_align_v2_kernel<<<1, kThreads, 0, stream>>>(wins, refp, jac, pref, vis, ox, oy, pose0,
                                                   lfac, out, N, Hl, Wl, scale, cam, n_iter,
                                                   eps);
  return (int)cudaGetLastError();
}
