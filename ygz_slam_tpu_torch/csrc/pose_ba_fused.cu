// K5: pose-only bundle adjustment, all rounds in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/pose_ba_fused.py::pose_only_ba_fused
// (_kernel with EARLY_EXIT and MAD_IN_KERNEL on).  The math, shared with
// K8, is in pose_ba.cuh.
//
// Bound: neither bytes nor operations.  The inputs are ~5 KB and the work
// ~1 MFLOP; the time is the chain of dependent block reductions (~10
// normal equations, the 2 x (1 + 4) reductions of the grouped bisection
// medians, a count per round).  So everything runs in one CTA, a thread per
// point: each normal equation is one transposed block sum of 28 values
// that every thread receives, and each thread solves the 6x6 system
// redundantly, so the pose never leaves registers and nothing returns to
// the host (pose_ba.cuh says how each link is kept short).
#include "pose_ba.cuh"

namespace {

__global__ void __launch_bounds__(kPoseBaThreads)
pose_ba_fused_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                     const bool* __restrict__ msk, const float* __restrict__ pose0,
                     float* __restrict__ out, float* __restrict__ inl,
                     float* __restrict__ wf, int N, float fx, float fy, float cx,
                     float cy, float chi2_th, int rounds, int iters, float eps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  pose_ba_cta(Obs{pts, px, msk, fx, fy, cx, cy}, pose0, out, inl, wf, N, chi2_th, rounds,
              iters, eps, red);
}

}  // namespace

extern "C" int pose_ba_fused_launch(const float* pts, const float* px, const bool* msk,
                                    const float* pose0, float* out, float* inl, float* wf,
                                    int N, float fx, float fy, float cx, float cy,
                                    float chi2_th, int rounds, int iters, float eps,
                                    cudaStream_t stream) {
  pose_ba_fused_kernel<<<1, pose_ba_threads(N), 0, stream>>>(pts, px, msk, pose0, out, inl,
                                                              wf, N, fx, fy, cx, cy, chi2_th,
                                                              rounds, iters, eps);
  return (int)cudaGetLastError();
}
