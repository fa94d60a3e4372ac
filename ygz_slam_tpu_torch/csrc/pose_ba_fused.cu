// K5: pose-only bundle adjustment, all rounds in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/pose_ba_fused.py::pose_only_ba_fused
// (_kernel with EARLY_EXIT and MAD_IN_KERNEL on).  The math, shared with
// K8, is in pose_ba.cuh.
//
// Bound: neither bytes nor operations.  The inputs are ~5 KB and the work
// ~1 MFLOP; the time is ~40 dependent iterations plus the 27 reductions of
// the bisection medians.  So everything runs in one CTA: each normal
// equation is one block sum of 28 values that every thread receives, and
// each thread solves the 6x6 system redundantly, so the pose never leaves
// registers and nothing returns to the host.
#include "pose_ba.cuh"

namespace {

__global__ void __launch_bounds__(1024)
pose_ba_fused_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                     const float* __restrict__ msk, const float* __restrict__ pose0,
                     float* __restrict__ out, float* __restrict__ inl,
                     float* __restrict__ wf, int N, float fx, float fy, float cx,
                     float cy, float chi2_th, int rounds, int iters, float eps) {
  __shared__ float smem[kMaxWarps * 28];
  pose_ba_cta(Obs{pts, px, msk, fx, fy, cx, cy}, pose0, out, inl, wf, N, chi2_th, rounds,
              iters, eps, smem);
}

}  // namespace

extern "C" int pose_ba_fused_launch(const float* pts, const float* px, const float* msk,
                                    const float* pose0, float* out, float* inl, float* wf,
                                    int N, float fx, float fy, float cx, float cy,
                                    float chi2_th, int rounds, int iters, float eps,
                                    int threads, cudaStream_t stream) {
  pose_ba_fused_kernel<<<1, threads, 0, stream>>>(pts, px, msk, pose0, out, inl, wf, N, fx,
                                                  fy, cx, cy, chi2_th, rounds, iters, eps);
  return (int)cudaGetLastError();
}
