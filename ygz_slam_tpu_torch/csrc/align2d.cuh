// The per-point body of 8x8 inverse-compositional patch alignment (du, dv,
// mean) inside a 32x32 cached window, run by one warp, shared by K4
// (align2d_fused.cu: steps clamped to +-1 px, DELTA_ROLLS's contract) and
// the second stage of K11 (track_fused.cu: unclamped steps, as
// ygz_slam_tpu/ops/pallas/track_fused.py runs them).
//
// Math of the JAX kernels: the sampling lattice clamped to [0, 23] inside
// the window, residual cur - ref + mean, update [du, dv, dm] = hinv [sum r
// jx, sum r jy, sum r], a point freezes once du^2 + dv^2 < eps^2 (that step
// is not applied), n_iter iterations, final err = mean |r| over the 64
// pixels.  Lane l owns pixels l (rows 0-3) and l + 32 (rows 4-7); the
// three sums of an iteration go through one butterfly whose every step
// shuffles all three, and no block barrier.  The loop ends once the point
// is frozen: its x, y and mean never change again and its error is
// sampled at the final x, so the result is the full loop's bit for bit
// (the JAX package's EARLY_EXIT was a barrier over all points; this exit
// is per point, and exact).
#pragma once

#include <cuda_runtime.h>

namespace ygz {
namespace align2d {

constexpr int kWin = 32;
constexpr int kPatch = 8;
constexpr float kHalf = 3.5f;                       // (PATCH - 1) / 2
constexpr float kLim = kWin - kPatch - 1;           // 23

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// warp_sum of a, b and c at once: each of the five butterfly steps shuffles
// the three values side by side (the same operations per value, so the
// same bits), one chain of shuffles and not three.
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(0xffffffffu, a, o);
    const float b2 = __shfl_xor_sync(0xffffffffu, b, o);
    const float c2 = __shfl_xor_sync(0xffffffffu, c, o);
    a += a2;
    b += b2;
    c += c2;
  }
}

// The bilinear sample at (x0 + c + ax, y0 + r + ay) of a window in device
// memory, its taps read through the read-only data path.
__device__ __forceinline__ float sample(const float* w, int y0, int x0, int r, int c,
                                        float ax, float ay) {
  const float* s = w + (y0 + r) * kWin + (x0 + c);
  return (1.f - ax) * (1.f - ay) * __ldg(s) + ax * (1.f - ay) * __ldg(s + 1) +
         (1.f - ax) * ay * __ldg(s + kWin) + ax * ay * __ldg(s + kWin + 1);
}

struct Result {
  float x, y, mean, err;
};

// Aligns one point by the whole warp (all 32 lanes active; every lane
// returns the same result).  w: its 32x32 window in device memory (read
// only) whose origin is (oxf, oyf); rp / gxp / gyp: its 64 reference values
// and gradients; h: its row-major 3x3 inverse normal matrix; (x, y): the
// init.
template <bool kClampStep>
__device__ __forceinline__ Result align_point(const float* w, const float* __restrict__ rp,
                                              const float* __restrict__ gxp,
                                              const float* __restrict__ gyp,
                                              const float* __restrict__ hp, float oxf,
                                              float oyf, float x, float y, int n_iter,
                                              float eps2) {
  const int lane = threadIdx.x & 31;
  const int r0 = lane >> 3, c0 = lane & 7, r1 = r0 + 4;
  const float ref0 = rp[lane], ref1 = rp[lane + 32];
  const float jx0 = gxp[lane], jx1 = gxp[lane + 32];
  const float jy0 = gyp[lane], jy1 = gyp[lane + 32];
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = hp[k];
  float mean = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const float fx = fminf(fmaxf(x - kHalf - oxf, 0.f), kLim);
    const float fy = fminf(fmaxf(y - kHalf - oyf, 0.f), kLim);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float ax = fx - x0, ay = fy - y0;
    const float e0 = sample(w, (int)y0, (int)x0, r0, c0, ax, ay) - ref0 + mean;
    const float e1 = sample(w, (int)y0, (int)x0, r1, c0, ax, ay) - ref1 + mean;
    float gx = e0 * jx0 + e1 * jx1;
    float gy = e0 * jy0 + e1 * jy1;
    float gm = e0 + e1;
    warp_sum3(gx, gy, gm);
    float du = h[0] * gx + h[1] * gy + h[2] * gm;
    float dv = h[3] * gx + h[4] * gy + h[5] * gm;
    const float dm = h[6] * gx + h[7] * gy + h[8] * gm;
    // Frozen: this step is not applied and the point no longer moves.  The
    // sums are the same bits in every lane, so the whole warp leaves.
    if (du * du + dv * dv < eps2) break;
    if (kClampStep) {
      du = fminf(fmaxf(du, -1.f), 1.f);
      dv = fminf(fmaxf(dv, -1.f), 1.f);
    }
    x -= du;
    y -= dv;
    mean -= dm;
  }
  const float fx = fminf(fmaxf(x - kHalf - oxf, 0.f), kLim);
  const float fy = fminf(fmaxf(y - kHalf - oyf, 0.f), kLim);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float ax = fx - x0, ay = fy - y0;
  const float e0 = sample(w, (int)y0, (int)x0, r0, c0, ax, ay) - ref0 + mean;
  const float e1 = sample(w, (int)y0, (int)x0, r1, c0, ax, ay) - ref1 + mean;
  const float err = warp_sum(fabsf(e0) + fabsf(e1)) / 64.f;
  return Result{x, y, mean, err};
}

}  // namespace align2d
}  // namespace ygz
