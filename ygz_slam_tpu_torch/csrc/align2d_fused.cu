// K4: batched 8x8 inverse-compositional patch alignment (du, dv, mean),
// the whole Gauss-Newton loop in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/align2d_fused.py::align2d_fused
// (_fused_kernel, default path: DELTA_ROLLS on, EARLY_EXIT off).  Same
// math, with steps clamped to +-1 px.  The TPU's lane-flattened windows
// and bit-masked roll chains are gone: each lane reads its pixels'
// bilinear taps directly.  The 256-row grid the TPU needed for N > 256 is
// not needed: the grid covers any N.
//
// Bound: neither bytes nor operations.  A frame moves ~1 MB (windows
// plus reference patches and gradients; ~0.3 us at 3.35 TB/s) and does
// ~0.3 MFLOP; the time is the launch and the chain of at most 10
// dependent iterations of the slowest point, each a sample of the window
// and a warp reduction of three sums.  The design (align2d.cuh): a warp
// per point, a block per warp (the warps spread over the SMs), the
// window read in place through the read-only path (no staging round
// before the first iteration), the three sums of an iteration in one
// butterfly, and the loop left once the point is frozen.  A sweep of 8,
// 16 and 32 lanes per point (several points per warp), 1, 4 and 8 warps
// per block and windows staged in shared memory or read in place chose
// this form: fewer lanes per point cost a lane more pixels than the
// shuffle steps they save, and every launch holds points that never
// freeze, so the slowest warp runs all 10 iterations (PERF.md).
#include "align2d.cuh"

using namespace ygz::align2d;

namespace {

// Block n aligns point n.
__global__ void __launch_bounds__(32)
align2d_fused_kernel(const float* __restrict__ wins, const float* __restrict__ ref,
                     const float* __restrict__ jx, const float* __restrict__ jy,
                     const float* __restrict__ hinv, const int* __restrict__ ox,
                     const int* __restrict__ oy, const float* __restrict__ xy0,
                     float* __restrict__ out, int n_iter, float eps2) {
  const int n = blockIdx.x;
  const Result r = align_point<true>(wins + (size_t)n * kWin * kWin, ref + (size_t)n * 64,
                                           jx + (size_t)n * 64, jy + (size_t)n * 64,
                                           hinv + (size_t)n * 9, (float)ox[n], (float)oy[n],
                                           xy0[2 * n], xy0[2 * n + 1], n_iter, eps2);
  if (threadIdx.x == 0) {
    out[4 * n] = r.x;
    out[4 * n + 1] = r.y;
    out[4 * n + 2] = r.mean;
    out[4 * n + 3] = r.err;
  }
}

}  // namespace

extern "C" int align2d_fused_launch(const float* wins, const float* ref, const float* jx,
                                    const float* jy, const float* hinv, const int* ox,
                                    const int* oy, const float* xy0, float* out, int N,
                                    int n_iter, float eps2, cudaStream_t stream) {
  if (N <= 0) return 0;
  align2d_fused_kernel<<<N, 32, 0, stream>>>(wins, ref, jx, jy, hinv, ox, oy, xy0, out, n_iter,
                                             eps2);
  return (int)cudaGetLastError();
}
