// Device code shared by the sparse-direct alignment kernels (K3
// sparse_align_mega.cu, K9 sparse_align_fused.cu, K11 track_fused.cu): the
// level geometry, the projection and masks of a point at a pose, the
// pixel-per-lane pass over every usable point's 4x4 patch (sampled
// bilinearly from its 16x16 window with ordinary indexed loads), the
// block-reduced normal equations of one pass, one level's loop on a frozen
// Hessian (K9 v2) and the coarse-to-fine loop over every level (K3 and
// K11).  K9 v1 runs the same pass over a thread-block cluster
// (sparse_align_fused.cu).
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

// Calls f(i, p, fx, fy, use) for pixel p (row-major in the 4x4 patch) of
// the points i, with use true exactly once for every pixel of every point
// usable at pose (R, t) and (fx, fy) its window-relative support origin.
// A pixel per lane: each half-warp takes one point at a time, lane p of
// it the point's pixel p, so the 16 lanes of a point read its 16 Jacobian
// rows (384 contiguous bytes), its patch and a 5x5 corner of its window
// side by side.  A warp owns P consecutive points per round (P even, at
// most 32, chosen so that the block's warps share the N points evenly);
// its lane j < P projects point base + j once, and the half-warps take
// the warp's points two at a time, reading the projection from lane j by
// shuffle.  Calls with use false come with i < N and (fx, fy) = (0, 0), so
// f may load unconditionally and select its contributions: the loop body
// has no branch.  Any multiple of 32 threads works.
template <class F>
__device__ __forceinline__ void for_each_pixel(const float R[9], const float t[3],
                                               const float* __restrict__ pref, int N,
                                               const Cam& c, const Level& lv, F&& f) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int half = lane >> 4, p = lane & 15;
  const int per = (N + nwarps - 1) / nwarps;
  const int P = min(32, per + (per & 1));
  for (int base = (threadIdx.x >> 5) * P; base < N; base += nwarps * P) {
    const int i = base + lane;
    float fx = 0.f, fy = 0.f;
    int ok = 0;
    if (lane < P && i < N) {
      float u, v, wx, wy;
      ok = project(R, t, pref, i, c, lv, u, v) && in_window(lv, i, u, v, wx, wy);
      if (ok) {
        fx = wx;
        fy = wy;
      }
    }
    // Two points per half-warp and step (s, then s + 2: the order of a
    // one-at-a-time loop), their shuffles first.  s + 2 + half < 32 since
    // s <= 28.
#pragma unroll 2
    for (int s = 0; s < P; s += 4) {
      const int src0 = s + half, src1 = s + 2 + half;
      const bool use0 = __shfl_sync(kFull, ok, src0) != 0;
      const float fx0 = __shfl_sync(kFull, fx, src0), fy0 = __shfl_sync(kFull, fy, src0);
      const bool use1 = __shfl_sync(kFull, ok, src1) != 0;
      const float fx1 = __shfl_sync(kFull, fx, src1), fy1 = __shfl_sync(kFull, fy, src1);
      f(min(base + src0, N - 1), p, fx0, fy0, use0);
      f(min(base + src1, N - 1), p, fx1, fy1, use1);
    }
  }
}

// Pixel p's bilinear sample of point i's window at support origin (fx, fy).
__device__ __forceinline__ float sample(const Level& lv, int i, int p, float fx, float fy) {
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float ax = fx - x0, ay = fy - y0;
  const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
  const float w10 = (1.f - ax) * ay, w11 = ax * ay;
  const float* s = lv.wins + (size_t)i * kCwin * kCwin + ((int)y0 + (p >> 2)) * kCwin +
                   (int)x0 + (p & 3);
  return w00 * s[0] + w01 * s[1] + w10 * s[kCwin] + w11 * s[kCwin + 1];
}

// Pixel p of point i at support origin (fx, fy): its residual and
// Jacobian row, both 0 unless `use` (a masked row may hold anything; it is
// read, never used).
__device__ __forceinline__ float pixel(const Level& lv, int i, int p, float fx, float fy,
                                       bool use, float Jp[6]) {
  const float* J = lv.jac + ((size_t)i * kNpix + p) * 6;
#pragma unroll
  for (int a = 0; a < 6; ++a) Jp[a] = use ? J[a] : 0.f;
  const float res = sample(lv, i, p, fx, fy) - lv.refp[(size_t)i * kNpix + p];
  return use ? res : 0.f;
}

// Gradient b = -sum J r and chi2 = sum r^2 / max(#pixels used, 1) at
// pose (R, t).  The sums accumulate by explicit fused multiply-adds (the
// build contracts nothing else): their order differs from the plain
// version's in any case, and a per-pixel value never decides alone.
template <class Red>
__device__ __forceinline__ void residual_pass(const float R[9], const float t[3],
                                              const float* pref, int N, const Cam& c,
                                              const Level& lv, float bv[6], float& chi2,
                                              Red& red) {
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for_each_pixel(R, t, pref, N, c, lv, [&](int i, int p, float fx, float fy, bool use) {
    float Jp[6];
    const float res = pixel(lv, i, p, fx, fy, use, Jp);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[a] = fmaf(-Jp[a], res, acc[a]);
    acc[6] = fmaf(res, res, acc[6]);
    acc[7] += use ? 1.f : 0.f;
  });
  red.sum(acc);
#pragma unroll
  for (int a = 0; a < 6; ++a) bv[a] = acc[a];
  chi2 = acc[6] / fmaxf(acc[7], 1.f);
}

// This thread's share of one normal-equation pass at pose (R, t) over
// points [0, N): acc[0..21) the upper-triangular J^T J, acc[21..27) -J^T r,
// acc[27] r^2, acc[28] the pixels used; no reduction.
__device__ __forceinline__ void normal_partials(const float R[9], const float t[3],
                                                const float* pref, int N, const Cam& c,
                                                const Level& lv, float (&acc)[29]) {
#pragma unroll
  for (int k = 0; k < 29; ++k) acc[k] = 0.f;
  for_each_pixel(R, t, pref, N, c, lv, [&](int i, int p, float fx, float fy, bool use) {
    float Jp[6];
    const float res = pixel(lv, i, p, fx, fy, use, Jp);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b, ++k) acc[k] = fmaf(Jp[a], Jp[b], acc[k]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] = fmaf(-Jp[a], res, acc[21 + a]);
    acc[27] = fmaf(res, res, acc[27]);
    acc[28] += use ? 1.f : 0.f;
  });
}

// H (21 upper-triangular sums), b = -sum J r and chi2 = sum r^2 /
// max(#pixels used, 1) at pose (R, t), in one pass and one 29-value
// reduction (each level's first pass in level_loop).  `red` is a Reducer,
// or anything with its sum<K>() (K9 v2 sums over a cluster).
template <class Red>
__device__ __forceinline__ void normal_eqs(const float R[9], const float t[3],
                                           const float* pref, int N, const Cam& c,
                                           const Level& lv, float (&h)[21], float bv[6],
                                           float& chi2, Red& red) {
  float acc[29];
  normal_partials(R, t, pref, N, c, lv, acc);
  red.sum(acc);
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

// How a level factors its frozen Hessian.
struct DampedFactor {      // K3 and K11's stage 1: chol6, pivot floor 1e-20
  __device__ __forceinline__ static void factor(const float h[21], float L[6][6]) {
    chol6(h, L);
  }
};
struct FrozenFactor {      // K9 v2: the JAX package's v2 rule, chol6_frozen
  __device__ __forceinline__ static void factor(const float h[21], float L[6][6]) {
    chol6_frozen(h, L);
  }
};

// One level's Gauss-Newton loop from the level-init pose (R, t): the
// Hessian frozen there (computed with the first residuals in the level's
// first pass; its 21 upper-triangular sums are left in h) and factored
// once by Factor, then up to n_iter substitution-only iterations with
// rollback on a chi2 increase and a stop at max|dx| < eps.  (R, t) and
// chi2 are refined in place, identical in every thread; every reduction
// goes through `red`.
template <class Factor, class Red>
__device__ __forceinline__ void level_loop(float R[9], float t[3], float& chi2, float (&h)[21],
                                           const float* __restrict__ pref, int N,
                                           const Cam& cam, const Level& lv, int n_iter,
                                           float eps, Red& red) {
  float Lc[6][6], bv[6];
  normal_eqs(R, t, pref, N, cam, lv, h, bv, chi2, red);
  Factor::factor(h, Lc);
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
    residual_pass(Rn, tn, pref, N, cam, lv, bn, chi2n, red);
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

// Every level's Gauss-Newton loop (level_loop with chol6), coarse (L - 1)
// to fine (0), by the whole CTA (K3, and the first stage of K11).  (R, t)
// is refined in place, identical in every thread; chi2 is the finest
// level's.  wins [L, N, 16, 16], refp [L, N, 16], jac [L, N, 16, 6], lvis
// / ox / oy [L, N], or sequence `seq`'s levels of such arrays stacked over
// sequences ([S, L, N, ...], K3's batched launch); every block reduction
// goes through `red`.
__device__ __forceinline__ void mega_levels(
    float R[9], float t[3], float& chi2, const float* __restrict__ wins,
    const float* __restrict__ refp, const float* __restrict__ jac, const float* __restrict__ pref,
    const float* __restrict__ lvis, const int* __restrict__ ox, const int* __restrict__ oy, int N,
    int L, int H0, int W0, const Cam& cam, int n_iter, float eps, Reducer& red, int seq = 0) {
  chi2 = 0.f;
  for (int li = L - 1; li >= 0; --li) {
    int Hl = H0, Wl = W0;
    for (int k = 0; k < li; ++k) { Hl = (Hl + 1) / 2; Wl = (Wl + 1) / 2; }
    Level lv;
    const size_t lvl = (size_t)seq * L + li;
    lv.wins = wins + lvl * N * kCwin * kCwin;
    lv.refp = refp + lvl * N * kNpix;
    lv.jac = jac + lvl * N * kNpix * 6;
    lv.vis = lvis + lvl * N;
    lv.ox = ox + lvl * N;
    lv.oy = oy + lvl * N;
    lv.scale = 1.f / (float)(1 << li);
    lv.Hl = (float)Hl;
    lv.Wl = (float)Wl;
    float h[21];
    level_loop<DampedFactor>(R, t, chi2, h, pref, N, cam, lv, n_iter, eps, red);
  }
}

}  // namespace sparse_align
}  // namespace ygz
