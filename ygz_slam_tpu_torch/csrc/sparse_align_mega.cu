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
// windows, bit-masked roll chains, [1,1] splat scalars) is gone: a lane
// reads its pixel's 2x2 support with ordinary indexed loads.
//
// Bound: neither bytes nor operations.  One frame reads ~0.6 MB of
// windows, patches and Jacobians (well under a microsecond at 3.35 TB/s)
// and does a few MFLOP; the time is the serial chain of dependent passes
// (~14 per frame: per level one pass for the frozen Hessian and the first
// residuals together, then one per iteration), each a sweep over the
// points and one block-wide reduction.  So the whole chain runs in one CTA
// (no grid-wide synchronisation, no host round trip), and the design
// shortens each link:
//   - a pixel per lane (sparse_align.cuh::for_each_pixel): a point's 16
//     pixels are 16 lanes, so a pass is ~N/32 short steps per warp with
//     loads side by side, not 16 serial pixels per thread with loads
//     384 B and 1 KB apart;
//   - a fixed block of 512 threads whatever N is (16 warps to cover the
//     L2 latency of each step), at a register budget with no spill;
//   - transposed warp reductions (common.cuh::Reducer): 9 shuffles for
//     the 8 values of a residual pass where one warp sum per value took
//     40, one barrier, one pass over the warps' partials;
// then every thread solves the 6x6 system redundantly in registers, so
// the pose never leaves registers.
//
// One launch aligns S sequences (the batch path's whole frame): a CTA per
// sequence, blockIdx.x its index, every array read at that sequence's
// offset ([S, L, N, ...] inputs, pose0 [S, 12], out [S, 13]).  The CTAs share
// nothing, so each runs its own per-level early exits and rollbacks and
// gives the bits its own launch would; the grid of S CTAs spreads over S
// of the 132 SMs and the S serial chains run side by side.  A single
// sequence (the monocular path) is the launch at S = 1.
#include "sparse_align.cuh"

using namespace ygz;
using namespace ygz::sparse_align;

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
sparse_align_mega_kernel(const float* __restrict__ wins, const float* __restrict__ refp,
                         const float* __restrict__ jac, const float* __restrict__ pref,
                         const float* __restrict__ lvis, const int* __restrict__ ox,
                         const int* __restrict__ oy, const float* __restrict__ pose0,
                         float* __restrict__ out, int N, int L, int H0, int W0, Cam cam,
                         int n_iter, float eps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  // The sequence's offsets are taken where each pointer is used, not added
  // to the pointers up front: that kept nine more pointers in registers and
  // spilled at the 128-register budget.
  const int seq = blockIdx.x;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[12 * seq + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[12 * seq + 9 + k];
  float chi2;
  mega_levels(R, t, chi2, wins, refp, jac, pref + (size_t)seq * N * 3, lvis, ox, oy, N, L, H0,
              W0, cam, n_iter, eps, red, seq);
  if (threadIdx.x == 0) {
    float* o = out + 13 * (size_t)blockIdx.x;
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) o[9 + k] = t[k];
    o[12] = chi2;
  }
}

}  // namespace

extern "C" int sparse_align_mega_launch(const float* wins, const float* refp,
                                        const float* jac, const float* pref,
                                        const float* lvis, const int* ox, const int* oy,
                                        const float* pose0, float* out, int S, int N,
                                        int L, int H0, int W0, float fx, float fy, float cx,
                                        float cy, float k1, float k2, float p1, float p2,
                                        int n_iter, float eps, cudaStream_t stream) {
  const Cam cam{fx, fy, cx, cy, k1, k2, p1, p2};
  sparse_align_mega_kernel<<<S, kThreads, 0, stream>>>(wins, refp, jac, pref, lvis, ox, oy,
                                                      pose0, out, N, L, H0, W0, cam,
                                                      n_iter, eps);
  return (int)cudaGetLastError();
}
