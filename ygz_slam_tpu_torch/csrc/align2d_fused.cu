// K4: batched 8x8 inverse-compositional patch alignment (du, dv, mean),
// the whole Gauss-Newton loop in one kernel.
//
// Replaces ygz_slam_tpu/ops/pallas/align2d_fused.py::align2d_fused
// (_fused_kernel, default path: DELTA_ROLLS on, EARLY_EXIT off).  Same
// math: the sampling lattice clamped to [0, 23] inside each point's
// 32x32 cached window, residual cur - ref + mean, update
// [du, dv, dm] = hinv [sum r jx, sum r jy, sum r], a point freezes once
// du^2 + dv^2 < eps^2 (that step is not applied), steps clamped to
// +-1 px, n_iter iterations, final err = mean |r| over the 64 pixels.
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
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;
constexpr int kPatch = 8;
constexpr int kWarps = 4;  // points per block
constexpr float kHalf = 3.5f;                       // (PATCH - 1) / 2
constexpr float kLim = kWin - kPatch - 1;           // 23

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sample(const float* w, int y0, int x0, int r, int c,
                                        float ax, float ay) {
  const float* s = w + (y0 + r) * kWin + (x0 + c);
  return (1.f - ax) * (1.f - ay) * s[0] + ax * (1.f - ay) * s[1] +
         (1.f - ax) * ay * s[kWin] + ax * ay * s[kWin + 1];
}

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

  // Lane owns pixels p = lane (rows 0-3) and lane + 32 (rows 4-7).
  const int r0 = lane >> 3, c0 = lane & 7, r1 = r0 + 4;
  const float* rp = ref + (size_t)n * 64;
  const float* gxp = jx + (size_t)n * 64;
  const float* gyp = jy + (size_t)n * 64;
  const float ref0 = rp[lane], ref1 = rp[lane + 32];
  const float jx0 = gxp[lane], jx1 = gxp[lane + 32];
  const float jy0 = gyp[lane], jy1 = gyp[lane + 32];
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = hinv[(size_t)n * 9 + k];
  const float oxf = (float)ox[n], oyf = (float)oy[n];
  float x = xy0[2 * n], y = xy0[2 * n + 1];
  float mean = 0.f;
  bool frozen = false;

  for (int it = 0; it < n_iter; ++it) {
    const float fx = fminf(fmaxf(x - kHalf - oxf, 0.f), kLim);
    const float fy = fminf(fmaxf(y - kHalf - oyf, 0.f), kLim);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float ax = fx - x0, ay = fy - y0;
    const float e0 = sample(w, (int)y0, (int)x0, r0, c0, ax, ay) - ref0 + mean;
    const float e1 = sample(w, (int)y0, (int)x0, r1, c0, ax, ay) - ref1 + mean;
    const float gx = warp_sum(e0 * jx0 + e1 * jx1);
    const float gy = warp_sum(e0 * jy0 + e1 * jy1);
    const float gm = warp_sum(e0 + e1);
    float du = h[0] * gx + h[1] * gy + h[2] * gm;
    float dv = h[3] * gx + h[4] * gy + h[5] * gm;
    const float dm = h[6] * gx + h[7] * gy + h[8] * gm;
    const bool small = du * du + dv * dv < eps2;
    du = fminf(fmaxf(du, -1.f), 1.f);
    dv = fminf(fmaxf(dv, -1.f), 1.f);
    if (!small && !frozen) {
      x -= du;
      y -= dv;
      mean -= dm;
    }
    frozen = frozen || small;
  }
  const float fx = fminf(fmaxf(x - kHalf - oxf, 0.f), kLim);
  const float fy = fminf(fmaxf(y - kHalf - oyf, 0.f), kLim);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float ax = fx - x0, ay = fy - y0;
  const float e0 = sample(w, (int)y0, (int)x0, r0, c0, ax, ay) - ref0 + mean;
  const float e1 = sample(w, (int)y0, (int)x0, r1, c0, ax, ay) - ref1 + mean;
  const float err = warp_sum(fabsf(e0) + fabsf(e1)) / 64.f;
  if (lane == 0) {
    out[4 * n] = x;
    out[4 * n + 1] = y;
    out[4 * n + 2] = mean;
    out[4 * n + 3] = err;
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
