// K8: S independent pose-only bundle adjustments in one launch.
//
// Replaces ygz_slam_tpu/ops/pallas/pose_ba_fused_batch.py::
// pose_only_ba_fused_batch.  The TPU kernel puts the sequences on the
// sublane axis and runs one shared early-exit loop until every sequence
// has stopped, each frozen once its own flag is set; so each sequence's
// result is the single-pose solve's.  On Hopper each sequence gets its own
// CTA running K5's body (pose_ba.cuh), which stops on its own.
//
// Bound: neither bytes nor operations, as for K5: each CTA is a chain of
// ~30 dependent block reductions.  S CTAs run side by side on S of the 132
// SMs, so the launch takes about as long as one K5 launch at these sizes.
#include "pose_ba.cuh"

namespace {

__global__ void __launch_bounds__(kPoseBaThreads)
pose_ba_fused_batch_kernel(const float* __restrict__ pts, const float* __restrict__ px,
                           const bool* __restrict__ msk, const float* __restrict__ pose0,
                           float* __restrict__ out, float* __restrict__ inl,
                           float* __restrict__ wf, int N, float fx, float fy, float cx,
                           float cy, float chi2_th, int rounds, int iters, float eps) {
  __shared__ float smem[kRedFloats];
  Reducer red(smem);
  const size_t s = blockIdx.x;
  pose_ba_cta(Obs{pts + s * N * 3, px + s * N * 2, msk + s * N, fx, fy, cx, cy},
              pose0 + s * 12, out + s * 13, inl + s * N, wf + s * N, N, chi2_th, rounds,
              iters, eps, red);
}

}  // namespace

extern "C" int pose_ba_fused_batch_launch(const float* pts, const float* px,
                                          const bool* msk, const float* pose0, float* out,
                                          float* inl, float* wf, int S, int N, float fx,
                                          float fy, float cx, float cy, float chi2_th,
                                          int rounds, int iters, float eps,
                                          cudaStream_t stream) {
  if (S <= 0) return 0;
  pose_ba_fused_batch_kernel<<<S, pose_ba_threads(N), 0, stream>>>(
      pts, px, msk, pose0, out, inl, wf, N, fx, fy, cx, cy, chi2_th, rounds, iters, eps);
  return (int)cudaGetLastError();
}
