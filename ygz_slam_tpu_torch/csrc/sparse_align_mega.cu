// K3: coarse-to-fine sparse-direct alignment, every pyramid level's
// Gauss-Newton loop in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/sparse_align_mega.py::sparse_align_mega
// (_mega_kernel).  The math is the TPU kernel's: windows fetched once at
// the frame-init pose (K1, SLACK 5 px per level), 4x4 patches bilinearly
// sampled inside them, points whose support leaves the window masked,
// per level a 6x6 Hessian frozen at the level-init pose and factored
// once, then up to n_iter substitution-only iterations with rollback on
// a chi2 increase, a stop at max|dx| < eps and the right retraction
// T <- T * exp(dx) by the Taylor series.  The TPU layout (lane-packed
// windows, bit-masked roll chains, [1,1] splat scalars) is gone: a thread
// reads its point's 5x5 support with ordinary indexed loads.
//
// Bound: neither bytes nor operations.  One frame reads ~0.6 MB of
// windows, patches and Jacobians (well under a microsecond at 3.35 TB/s)
// and does a few MFLOP; the time is the serial chain of dependent
// iterations, each one residual pass and one block-wide reduction.  So
// the whole chain runs in one CTA (no grid-wide synchronisation, no
// host round trip): threads own points, every iteration ends in a block
// sum that all threads receive, and each thread then solves the 6x6
// system redundantly in registers, so the pose never leaves registers.
#include "sparse_align.cuh"

using namespace ygz;
using namespace ygz::sparse_align;

namespace {

__global__ void __launch_bounds__(1024)
sparse_align_mega_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                         const float* __restrict__ jac, const float* __restrict__ pref,
                         const float* __restrict__ lvis, const int* __restrict__ ox,
                         const int* __restrict__ oy, const float* __restrict__ pose0,
                         float* __restrict__ out, int N, int L, int H0, int W0, Cam cam,
                         int n_iter, float eps) {
  __shared__ float smem[kMaxWarps * 21];
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  float chi2 = 0.f;
  for (int li = L - 1; li >= 0; --li) {
    int Hl = H0, Wl = W0;
    for (int k = 0; k < li; ++k) { Hl = (Hl + 1) / 2; Wl = (Wl + 1) / 2; }
    Level lv;
    lv.wins = wins + (size_t)li * N * kCwin * kCwin;
    lv.refp = refp + (size_t)li * N * kNpix;
    lv.jac = jac + (size_t)li * N * kNpix * 6;
    lv.vis = lvis + (size_t)li * N;
    lv.ox = ox + (size_t)li * N;
    lv.oy = oy + (size_t)li * N;
    lv.scale = 1.f / (float)(1 << li);
    lv.Hl = (float)Hl;
    lv.Wl = (float)Wl;

    float h[21], Lc[6][6];
    hessian(R, t, pref, N, cam, lv, h, smem);
    chol6(h, Lc);
    float bv[6];
    residual_pass(R, t, pref, N, cam, lv, bv, chi2, smem);
    bool stop = false;
    for (int it = 0; !stop && it < n_iter; ++it) {
      float dx[6];
      subst6(Lc, bv, dx);
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) amax = fmaxf(amax, fabsf(dx[k]));
      const bool conv = amax < eps;
      float Rn[9], tn[3];
      retract_right(R, t, dx, Rn, tn);
      float bn[6], chi2n;
      residual_pass(Rn, tn, pref, N, cam, lv, bn, chi2n, smem);
      const bool worse = !(chi2n <= chi2);  // a NaN trial counts as worse
      if (!worse) {
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
#pragma unroll
        for (int k = 0; k < 6; ++k) bv[k] = bn[k];
        chi2 = chi2n;
      }
      stop = worse || conv;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[9 + k] = t[k];
    out[12] = chi2;
  }
}

}  // namespace

extern "C" int sparse_align_mega_launch(const float* wins, const float* refp,
                                        const float* jac, const float* pref,
                                        const float* lvis, const int* ox, const int* oy,
                                        const float* pose0, float* out, int N, int L,
                                        int H0, int W0, float fx, float fy, float cx,
                                        float cy, float k1, float k2, float p1, float p2,
                                        int n_iter, float eps, int threads,
                                        cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  sparse_align_mega_kernel<<<1, threads, 0, stream>>>(wins, refp, jac, pref, lvis, ox, oy,
                                                      pose0, out, N, L, H0, W0, cam,
                                                      n_iter, eps);
  return (int)cudaGetLastError();
}
