// The CTA body of pose-only bundle adjustment, shared by K5
// (pose_ba_fused.cu: one pose, one CTA) and K8 (pose_ba_fused_batch.cu:
// S poses, one CTA each).
//
// Same math as ygz_slam_tpu/ops/pallas/pose_ba_fused.py::_kernel (with
// EARLY_EXIT and MAD_IN_KERNEL on): pinhole reprojection with MIN_DEPTH
// 1e-2, robust weights frozen at each round's starting pose (round 0 Tukey
// with a MAD scale from two 12-step bisection medians, middle rounds Huber
// with k = sqrt(chi2_th), the last round unit weights), per round up to
// `iters` Gauss-Newton iterations with rollback on a chi2 increase and a
// stop at max|dx| < eps, the left retraction T <- exp(dx) * T by the
// Taylor series, and chi2 reclassification that keeps the old inlier set
// when no point passes.  The TPU's lane layout and [1,1] splat scalars are
// gone: one thread per point (a loop when N exceeds the block), the pose
// in registers.
//
// Everything here has internal linkage: each kernel source that includes
// it compiles its own copy, exactly as if the code were written inline.
#pragma once

#include "common.cuh"

using namespace ygz;

namespace {

constexpr float kMinDepth = 1e-2f;
constexpr float kTukeyB = 4.6851f;
constexpr float kMadScale = 1.4826f;

struct Obs {
  const float* pts;  // [N, 3]
  const float* px;   // [N, 2]
  const float* msk;  // [N]
  float fx, fy, cx, cy;
};

// Residual (ru, rv), Jacobian rows and cheirality of point i at (R, t).
__device__ __forceinline__ float reproj(const float R[9], const float t[3], const Obs& o,
                                        int i, float& ru, float& rv, float Ju[6],
                                        float Jv[6]) {
  const float X = o.pts[3 * i], Y = o.pts[3 * i + 1], Z = o.pts[3 * i + 2];
  const float x = R[0] * X + R[1] * Y + R[2] * Z + t[0];
  const float y = R[3] * X + R[4] * Y + R[5] * Z + t[1];
  const float z = R[6] * X + R[7] * Y + R[8] * Z + t[2];
  const float valid = o.msk[i] * (z > kMinDepth ? 1.f : 0.f);
  const float zi = 1.f / fmaxf(z, kMinDepth);
  const float zi2 = zi * zi;
  ru = o.fx * x * zi + o.cx - o.px[2 * i];
  rv = o.fy * y * zi + o.cy - o.px[2 * i + 1];
  Ju[0] = o.fx * zi; Ju[1] = 0.f; Ju[2] = -o.fx * x * zi2;
  Ju[3] = -o.fx * x * y * zi2; Ju[4] = o.fx * (1.f + x * x * zi2); Ju[5] = -o.fx * y * zi;
  Jv[0] = 0.f; Jv[1] = o.fy * zi; Jv[2] = -o.fy * y * zi2;
  Jv[3] = -o.fy * (1.f + y * y * zi2); Jv[4] = o.fy * x * y * zi2; Jv[5] = o.fy * x * zi;
  return valid;
}

// Normal equations under the frozen weights wf (re-masked by the trial
// pose's cheirality): acc[0..20] H, acc[21..26] b, acc[27] chi2.
__device__ void normal_eq(const float R[9], const float t[3], const Obs& o,
                          const float* wf, int N, float (&acc)[28], float* smem) {
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float ru, rv, Ju[6], Jv[6];
    const float w = wf[i] * reproj(R, t, o, i, ru, rv, Ju, Jv);
    if (w == 0.f) continue;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wJu = w * Ju[a], wJv = w * Jv[a];
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += wJu * Ju[b] + wJv * Jv[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] -= w * (Ju[a] * ru + Jv[a] * rv);
    acc[27] += w * (ru * ru + rv * rv);
  }
  block_sum<28>(acc, smem);
}

__device__ __forceinline__ float point_rn(const float R[9], const float t[3], const Obs& o,
                                          const float* inl, int i, float& valid0) {
  float ru, rv, Ju[6], Jv[6];
  valid0 = reproj(R, t, o, i, ru, rv, Ju, Jv) * inl[i];
  return sqrtf(ru * ru + rv * rv);
}

// Masked median of |rn - center| (center 0: of rn itself) over valid0 by
// 12 bisection steps on [0, max].
__device__ float med_bisect(const float R[9], const float t[3], const Obs& o,
                            const float* inl, int N, float center, float half_cnt,
                            float* smem) {
  float hi = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v0;
    const float val = fabsf(point_rn(R, t, o, inl, i, v0) - center);
    hi = fmaxf(hi, val * v0);
  }
  hi = block_max(hi, smem);
  float lo = 0.f;
  for (int s = 0; s < 12; ++s) {
    const float mid = 0.5f * (lo + hi);
    float cnt[1] = {0.f};
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float v0;
      const float val = fabsf(point_rn(R, t, o, inl, i, v0) - center);
      cnt[0] += v0 * (val <= mid ? 1.f : 0.f);
    }
    block_sum<1>(cnt, smem);
    if (cnt[0] >= half_cnt) hi = mid; else lo = mid;
  }
  return 0.5f * (lo + hi);
}

// One pose-only BA by the whole CTA: pose0 [12] (R row-major, t) in,
// out [13] (R, t, last round's chi2) and inl [N] (0/1) out; wf [N] is
// scratch.  smem holds kMaxWarps * 28 floats.
__device__ __forceinline__ void pose_ba_cta(const Obs& o, const float* __restrict__ pose0,
                                            float* __restrict__ out, float* __restrict__ inl,
                                            float* __restrict__ wf, int N, float chi2_th,
                                            int rounds, int iters, float eps, float* smem) {
  const float huber_k = sqrtf(chi2_th);
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  // Each thread touches only its own points in inl / wf: no barrier
  // is needed between writing and reading them.
  for (int i = threadIdx.x; i < N; i += blockDim.x) inl[i] = o.msk[i];
  float chi2_out = 0.f;

  for (int round = 0; round < rounds; ++round) {
    float sigma0 = 1.f;
    if (round == 0) {
      float cnt[1] = {0.f};
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        float v0;
        point_rn(R, t, o, inl, i, v0);
        cnt[0] += v0;
      }
      block_sum<1>(cnt, smem);
      const float half_cnt = 0.5f * cnt[0];
      const float med = med_bisect(R, t, o, inl, N, 0.f, half_cnt, smem);
      // |rn - med| bisection: center med instead of 0.
      const float mad = med_bisect(R, t, o, inl, N, med, half_cnt, smem);
      sigma0 = fmaxf(kMadScale * mad, 1.f);
    }
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float v0;
      const float rn = point_rn(R, t, o, inl, i, v0);
      float w;
      if (round == 0) {
        const float xw = rn / (sigma0 * kTukeyB);
        const float wt = 1.f - xw * xw;
        w = fabsf(xw) < 1.f ? wt * wt : 0.f;
      } else if (round < rounds - 1) {
        w = rn <= huber_k ? 1.f : huber_k / fmaxf(rn, 1e-12f);
      } else {
        w = 1.f;
      }
      wf[i] = w * v0;
    }

    float ne[28];
    normal_eq(R, t, o, wf, N, ne, smem);
    float chi2 = ne[27];
    bool stop = false;
    for (int it = 0; !stop && it < iters; ++it) {
      float dx[6];
      solve6(ne, ne + 21, dx);
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) amax = fmaxf(amax, fabsf(dx[k]));
      const bool conv = amax < eps;
      float Re[9], te[3], Rn[9], tn[3];
      exp_se3_taylor(dx, Re, te);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rn[3 * i + j] = Re[3 * i] * R[j] + Re[3 * i + 1] * R[3 + j] + Re[3 * i + 2] * R[6 + j];
        tn[i] = Re[3 * i] * t[0] + Re[3 * i + 1] * t[1] + Re[3 * i + 2] * t[2] + te[i];
      }
      float nn[28];
      normal_eq(Rn, tn, o, wf, N, nn, smem);
      const bool worse = !(nn[27] <= chi2);  // a NaN trial counts as worse
      if (!worse) {
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
#pragma unroll
        for (int k = 0; k < 28; ++k) ne[k] = nn[k];
        chi2 = nn[27];
      }
      stop = worse || conv;
    }
    chi2_out = chi2;

    // Reclassify at the round's final pose; keep the old set if no point
    // passes.  wf is free now and holds the new flags.
    float cnt[1] = {0.f};
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float ru, rv, Ju[6], Jv[6];
      const float valid = reproj(R, t, o, i, ru, rv, Ju, Jv);
      const float nw = valid * (ru * ru + rv * rv < chi2_th ? 1.f : 0.f);
      wf[i] = nw;
      cnt[0] += nw;
    }
    block_sum<1>(cnt, smem);
    if (cnt[0] > 0.5f)
      for (int i = threadIdx.x; i < N; i += blockDim.x) inl[i] = wf[i];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[9 + k] = t[k];
    out[12] = chi2_out;
  }
}

}  // namespace
