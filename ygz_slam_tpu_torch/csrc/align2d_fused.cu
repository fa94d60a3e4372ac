// K4: batched 8x8 inverse-compositional patch alignment (du, dv, mean),
// the whole Gauss-Newton loop in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/align2d_fused.py::align2d_fused
// (_fused_kernel, default path: DELTA_ROLLS on, EARLY_EXIT off).  Same
// math, in align2d.cuh (shared with K11), with steps clamped to +-1 px.
// The TPU's lane-flattened windows and bit-masked roll chains are gone:
// the window sits in shared memory and each lane reads its two pixels'
// bilinear taps directly.  The 256-row grid the TPU needed for N > 256
// is not needed: the grid covers any N.
//
// Bound: neither bytes nor operations.  A frame moves ~1 MB (windows
// plus reference patches and gradients; ~0.3 us at 3.35 TB/s) and does
// ~0.3 MFLOP; the time is the launch and the 10 dependent iterations,
// each a warp-wide reduction.  So one warp owns one point: its window
// (4 KB) is loaded once into shared memory, every lane holds two of the
// 64 pixels' reference values and gradients in registers, and an
// iteration costs three warp shuffles-reductions and no block barrier.
#include "align2d.cuh"

using namespace ygz::align2d;

namespace {

constexpr int kWarps = 4;  // points per block

__global__ void __launch_bounds__(kWarps * 32)
align2d_fused_kernel(const float* __restrict__ wins, const float* __restrict__ ref,
                     const float* __restrict__ jx, const float* __restrict__ jy,
                     const float* __restrict__ hinv, const int* __restrict__ ox,
                     const int* __restrict__ oy, const float* __restrict__ xy0,
                     float* __restrict__ out, int N, int n_iter, float eps2) {
  __shared__ float sw[kWarps][kWin * kWin];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;  // whole warps leave; no block barrier below
  float* w = sw[warp];
  const float* src = wins + (size_t)n * kWin * kWin;
  for (int k = lane; k < kWin * kWin; k += 32) w[k] = src[k];
  __syncwarp();

  const Result r = align_point<true>(w, ref + (size_t)n * 64, jx + (size_t)n * 64,
                                     jy + (size_t)n * 64, hinv + (size_t)n * 9,
                                     (float)ox[n], (float)oy[n], xy0[2 * n], xy0[2 * n + 1],
                                     n_iter, eps2);
  if (lane == 0) {
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
  const int blocks = (N + kWarps - 1) / kWarps;
  align2d_fused_kernel<<<blocks, kWarps * 32, 0, stream>>>(wins, ref, jx, jy, hinv, ox, oy,
                                                           xy0, out, N, n_iter, eps2);
  return (int)cudaGetLastError();
}
