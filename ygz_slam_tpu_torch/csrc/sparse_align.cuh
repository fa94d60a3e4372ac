// Device code shared by the sparse-direct alignment kernels (K3
// sparse_align_mega.cu, K9 sparse_align_fused.cu): the level geometry,
// the projection and masks of a point at a pose, its 4x4 patch sampled
// bilinearly from its 16x16 window with ordinary indexed loads, and the
// block-reduced normal equations of one residual pass.
#pragma once

#include "common.cuh"

namespace ygz {
namespace sparse_align {

constexpr int kCwin = 16;           // window side
constexpr int kPatch = 4;           // 4x4 patch
constexpr int kNpix = kPatch * kPatch;
constexpr float kMaxPos = kCwin - (kPatch + 1);  // 11: support must fit
constexpr float kHalf = 1.5f;       // patch grid arange(4) - 1.5
constexpr float kMargin = 4.f;      // in_bounds margin PATCH_HALF + 2

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2;
};

struct Level {
  const float* wins;  // [N, 16, 16]
  const float* refp;  // [N, 16]
  const float* jac;   // [N, 16, 6]
  const float* vis;   // [N]
  const int* ox;      // [N]
  const int* oy;      // [N]
  float scale, Hl, Wl;
};

// Pixel of point i at pose (R, t) on the level, and whether it is usable
// there (visible, in front, inside the image margins).
__device__ __forceinline__ bool project(const float R[9], const float t[3],
                                        const float* __restrict__ pref, int i,
                                        const Cam& c, const Level& lv, float& u,
                                        float& v) {
  const float px = pref[3 * i], py = pref[3 * i + 1], pz = pref[3 * i + 2];
  const float x = R[0] * px + R[1] * py + R[2] * pz + t[0];
  const float y = R[3] * px + R[4] * py + R[5] * pz + t[1];
  const float z = R[6] * px + R[7] * py + R[8] * pz + t[2];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float xn = x / zs, yn = y / zs;
  const float r2 = xn * xn + yn * yn;
  const float radial = 1.f + c.k1 * r2 + c.k2 * r2 * r2;
  const float xd = xn * radial + 2.f * c.p1 * xn * yn + c.p2 * (r2 + 2.f * xn * xn);
  const float yd = yn * radial + c.p1 * (r2 + 2.f * yn * yn) + 2.f * c.p2 * xn * yn;
  u = (c.fx * lv.scale) * xd + c.cx * lv.scale;
  v = (c.fy * lv.scale) * yd + c.cy * lv.scale;
  return lv.vis[i] > 0.5f && z > 1e-3f && u >= kMargin && u < lv.Wl - 1.f - kMargin &&
         v >= kMargin && v < lv.Hl - 1.f - kMargin;
}

// Window-relative support origin of point i; false when the support
// leaves the window (the point is masked, not clamped).
__device__ __forceinline__ bool in_window(const Level& lv, int i, float u, float v,
                                          float& fx, float& fy) {
  fx = u - kHalf - (float)lv.ox[i];
  fy = v - kHalf - (float)lv.oy[i];
  return fx >= 0.f && fx <= kMaxPos && fy >= 0.f && fy <= kMaxPos;
}

// Frozen Hessian (21 upper-triangular sums) at pose (R, t).
__device__ inline void hessian(const float R[9], const float t[3], const float* pref, int N,
                               const Cam& c, const Level& lv, float (&h)[21], float* smem) {
#pragma unroll
  for (int k = 0; k < 21; ++k) h[k] = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float u, v, fx, fy;
    if (!project(R, t, pref, i, c, lv, u, v) || !in_window(lv, i, u, v, fx, fy)) continue;
    const float* J = lv.jac + (size_t)i * kNpix * 6;
    for (int p = 0; p < kNpix; ++p) {
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) h[k++] += J[6 * p + a] * J[6 * p + b];
    }
  }
  block_sum<21>(h, smem);
}

// Gradient b = -sum J r and chi2 = sum r^2 / max(#pixels used, 1) at
// pose (R, t).
__device__ inline void residual_pass(const float R[9], const float t[3], const float* pref,
                                     int N, const Cam& c, const Level& lv, float bv[6],
                                     float& chi2, float* smem) {
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float u, v, fx, fy;
    if (!project(R, t, pref, i, c, lv, u, v) || !in_window(lv, i, u, v, fx, fy)) continue;
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float ax = fx - x0, ay = fy - y0;
    const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
    const float w10 = (1.f - ax) * ay, w11 = ax * ay;
    const float* w = lv.wins + (size_t)i * kCwin * kCwin + (int)y0 * kCwin + (int)x0;
    const float* rp = lv.refp + (size_t)i * kNpix;
    const float* J = lv.jac + (size_t)i * kNpix * 6;
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int q = 0; q < kPatch; ++q) {
        const float* s = w + r * kCwin + q;
        const float cur = w00 * s[0] + w01 * s[1] + w10 * s[kCwin] + w11 * s[kCwin + 1];
        const float res = cur - rp[r * kPatch + q];
        const int p = r * kPatch + q;
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[a] -= J[6 * p + a] * res;
        acc[6] += res * res;
      }
    acc[7] += (float)kNpix;
  }
  block_sum<8>(acc, smem);
#pragma unroll
  for (int a = 0; a < 6; ++a) bv[a] = acc[a];
  chi2 = acc[6] / fmaxf(acc[7], 1.f);
}

// H (21 upper-triangular sums), b = -sum J r and chi2 = sum r^2 /
// max(#pixels used, 1) at pose (R, t), in one pass and one 29-float block
// reduction (the per-iteration normal equations of K9 v1).
__device__ inline void normal_eqs(const float R[9], const float t[3], const float* pref,
                                  int N, const Cam& c, const Level& lv, float (&h)[21],
                                  float bv[6], float& chi2, float* smem) {
  float acc[29];
#pragma unroll
  for (int k = 0; k < 29; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float u, v, fx, fy;
    if (!project(R, t, pref, i, c, lv, u, v) || !in_window(lv, i, u, v, fx, fy)) continue;
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float ax = fx - x0, ay = fy - y0;
    const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
    const float w10 = (1.f - ax) * ay, w11 = ax * ay;
    const float* w = lv.wins + (size_t)i * kCwin * kCwin + (int)y0 * kCwin + (int)x0;
    const float* rp = lv.refp + (size_t)i * kNpix;
    const float* J = lv.jac + (size_t)i * kNpix * 6;
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int q = 0; q < kPatch; ++q) {
        const float* s = w + r * kCwin + q;
        const float cur = w00 * s[0] + w01 * s[1] + w10 * s[kCwin] + w11 * s[kCwin + 1];
        const float res = cur - rp[r * kPatch + q];
        const float* Jp = J + 6 * (r * kPatch + q);
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = a; b < 6; ++b) acc[k++] += Jp[a] * Jp[b];
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[21 + a] -= Jp[a] * res;
        acc[27] += res * res;
      }
    acc[28] += (float)kNpix;
  }
  block_sum<29>(acc, smem);
#pragma unroll
  for (int k = 0; k < 21; ++k) h[k] = acc[k];
#pragma unroll
  for (int a = 0; a < 6; ++a) bv[a] = acc[21 + a];
  chi2 = acc[27] / fmaxf(acc[28], 1.f);
}

// T <- T * exp(dx): (Rn, tn) from (R, t).
__device__ __forceinline__ void retract_right(const float R[9], const float t[3],
                                              const float dx[6], float Rn[9], float tn[3]) {
  float Re[9], te[3];
  exp_se3_taylor(dx, Re, te);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = R[3 * i] * Re[j] + R[3 * i + 1] * Re[3 + j] + R[3 * i + 2] * Re[6 + j];
    tn[i] = R[3 * i] * te[0] + R[3 * i + 1] * te[1] + R[3 * i + 2] * te[2] + t[i];
  }
}

}  // namespace sparse_align
}  // namespace ygz
