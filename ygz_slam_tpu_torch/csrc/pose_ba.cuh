// The CTA body of pose-only bundle adjustment, shared by K5
// (pose_ba_fused.cu: one pose, one CTA), K8 (pose_ba_fused_batch.cu: S
// poses, one CTA each) and K11's third stage (track_fused.cu).
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
// gone: one thread per point, the pose in registers.
//
// The time is the chain of dependent block reductions (~25 per launch),
// so the design shortens the chain and each link:
//   - the 12 bisection steps of a median run as 4 groups of 3: a group
//     counts the 7 thresholds the next 3 steps could visit (each computed
//     with the float operations of its branch, mid = 0.5f * (lo + hi)) in
//     one reduction and then walks the 3 decisions, so lo and hi come out
//     bit for bit as from 12 steps (the counts are exact integers);
//   - a single count is one __syncthreads_count when each thread holds at
//     most one point (every path's N: K5 and K8 launch a thread per point
//     up to 512, K11 up to 1024);
//   - the 28 sums of a normal equation are one transposed warp reduction
//     (31 shuffles, common.cuh::Reducer) and one pass over the warps'
//     partials;
//   - with at most one point per thread, the point (pts, px, msk), its
//     inlier flag and its weight stay in registers across the rounds.
// Larger N takes the same code with a loop over each thread's points and
// their flags and weights in device memory.  msk is a bool per point (a
// weight of 0 or 1: the counts above rely on it).
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
  const bool* msk;   // [N]
  float fx, fy, cx, cy;
};

struct Pt {
  float X, Y, Z, u, v, m;
};

__device__ __forceinline__ Pt load_pt(const Obs& o, int i) {
  return Pt{o.pts[3 * i], o.pts[3 * i + 1], o.pts[3 * i + 2], o.px[2 * i], o.px[2 * i + 1],
            o.msk[i] ? 1.f : 0.f};
}

// Residual (ru, rv), Jacobian rows and cheirality of point p at (R, t).
__device__ __forceinline__ float reproj(const float R[9], const float t[3], const Obs& o,
                                        const Pt& p, float& ru, float& rv, float Ju[6],
                                        float Jv[6]) {
  const float x = R[0] * p.X + R[1] * p.Y + R[2] * p.Z + t[0];
  const float y = R[3] * p.X + R[4] * p.Y + R[5] * p.Z + t[1];
  const float z = R[6] * p.X + R[7] * p.Y + R[8] * p.Z + t[2];
  const float valid = p.m * (z > kMinDepth ? 1.f : 0.f);
  const float zi = 1.f / fmaxf(z, kMinDepth);
  const float zi2 = zi * zi;
  ru = o.fx * x * zi + o.cx - p.u;
  rv = o.fy * y * zi + o.cy - p.v;
  Ju[0] = o.fx * zi; Ju[1] = 0.f; Ju[2] = -o.fx * x * zi2;
  Ju[3] = -o.fx * x * y * zi2; Ju[4] = o.fx * (1.f + x * x * zi2); Ju[5] = -o.fx * y * zi;
  Jv[0] = 0.f; Jv[1] = o.fy * zi; Jv[2] = -o.fy * y * zi2;
  Jv[3] = -o.fy * (1.f + y * y * zi2); Jv[4] = o.fy * x * y * zi2; Jv[5] = o.fy * x * zi;
  return valid;
}

// Reprojection error norm of point p at (R, t), and its round-0 weight
// mask valid0 = cheirality * inlier flag.
__device__ __forceinline__ float point_rn(const float R[9], const float t[3], const Obs& o,
                                          const Pt& p, float inl, float& valid0) {
  float ru, rv, Ju[6], Jv[6];
  valid0 = reproj(R, t, o, p, ru, rv, Ju, Jv) * inl;
  return sqrtf(ru * ru + rv * rv);
}

// A thread's points.  kOne (N <= blockDim.x): at most one, which with its
// inlier flag and weight stays in registers.  Otherwise every point of the
// thread (i = threadIdx.x + k * blockDim.x), its flag and weight in inl /
// wf (a thread touches only its own rows: no barrier between writes and
// reads).
template <bool kOne>
struct Points {
  const Obs& o;
  float* inl;
  float* wf;
  int N;
  bool have;
  Pt mine;
  float inl_r, wf_r;

  __device__ __forceinline__ Points(const Obs& o_, float* inl_, float* wf_, int N_)
      : o(o_), inl(inl_), wf(wf_), N(N_), have((int)threadIdx.x < N_), mine{}, inl_r(0.f),
        wf_r(0.f) {
    if (kOne) {
      if (have) {
        mine = load_pt(o, threadIdx.x);
        inl_r = mine.m;
      }
    } else {
      for (int i = threadIdx.x; i < N; i += blockDim.x) inl[i] = o.msk[i] ? 1.f : 0.f;
    }
  }

  // f(point, its inlier flag, its weight) for each of the thread's points.
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    if (kOne) {
      if (have) f(mine, inl_r, wf_r);
    } else {
      for (int i = threadIdx.x; i < N; i += blockDim.x) f(load_pt(o, i), inl[i], wf[i]);
    }
  }

  // The block's total of per-thread counts c (0 or 1 when kOne).
  __device__ __forceinline__ float count(float c, Reducer& red) {
    if (kOne) return (float)__syncthreads_count(c != 0.f);
    float v[1] = {c};
    red.sum(v);
    return v[0];
  }

  // Each thread's final inlier flags in inl.
  __device__ __forceinline__ void publish() {
    if (kOne && have) inl[threadIdx.x] = inl_r;
  }
};

// Masked median of |rn - center| (center 0: of rn itself) over valid0:
// 12 bisection steps on [0, max], 3 per reduction.  Each point's value
// (or -1 where valid0 is 0) waits in its weight slot, which round 0 fills
// only after both medians.
template <bool kOne>
__device__ __forceinline__ float med_bisect(Points<kOne>& pts, const float R[9],
                                            const float t[3], float center, float half_cnt,
                                            Reducer& red) {
  const Obs& o = pts.o;
  float hi = 0.f;
  pts.each([&](const Pt& p, float in, float& slot) {
    float v0;
    const float val = fabsf(point_rn(R, t, o, p, in, v0) - center);
    hi = fmaxf(hi, val * v0);
    slot = v0 != 0.f ? val : -1.f;
  });
  hi = red.max(hi);
  float lo = 0.f;
  for (int g = 0; g < 4; ++g) {
    // The 7 midpoints of the next 3 steps: m[0] first, m[1] / m[2] after
    // going left (hi = m[0]) / right (lo = m[0]), m[3..6] after left-left,
    // left-right, right-left, right-right.
    float m[7];
    m[0] = 0.5f * (lo + hi);
    m[1] = 0.5f * (lo + m[0]);
    m[2] = 0.5f * (m[0] + hi);
    m[3] = 0.5f * (lo + m[1]);
    m[4] = 0.5f * (m[1] + m[0]);
    m[5] = 0.5f * (m[0] + m[2]);
    m[6] = 0.5f * (m[2] + hi);
    float c[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) c[k] = 0.f;
    pts.each([&](const Pt&, float, float val) {
#pragma unroll
      for (int k = 0; k < 7; ++k) c[k] += val >= 0.f && val <= m[k] ? 1.f : 0.f;
    });
    red.sum(c);
    const bool l0 = c[0] >= half_cnt;       // step 1: left keeps [lo, m0]
    if (l0) hi = m[0]; else lo = m[0];
    const float c1 = l0 ? c[1] : c[2], m1 = l0 ? m[1] : m[2];
    const bool l1 = c1 >= half_cnt;
    if (l1) hi = m1; else lo = m1;
    const float c2 = l0 ? (l1 ? c[3] : c[4]) : (l1 ? c[5] : c[6]);
    const float m2 = l0 ? (l1 ? m[3] : m[4]) : (l1 ? m[5] : m[6]);
    if (c2 >= half_cnt) hi = m2; else lo = m2;
  }
  return 0.5f * (lo + hi);
}

// Normal equations under the frozen weights (re-masked by the trial pose's
// cheirality): acc[0..20] H (by fused multiply-adds, as sparse_align.cuh's
// sums), acc[21..26] b, acc[27] chi2.
template <bool kOne>
__device__ __forceinline__ void normal_eq(Points<kOne>& pts, const float R[9],
                                          const float t[3], float (&acc)[28], Reducer& red) {
  const Obs& o = pts.o;
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] = 0.f;
  pts.each([&](const Pt& p, float, float wq) {
    float ru, rv, Ju[6], Jv[6];
    const float w = wq * reproj(R, t, o, p, ru, rv, Ju, Jv);
    if (w == 0.f) return;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wJu = w * Ju[a], wJv = w * Jv[a];
#pragma unroll
      for (int b = a; b < 6; ++b, ++k) acc[k] = fmaf(wJv, Jv[b], fmaf(wJu, Ju[b], acc[k]));
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] -= w * (Ju[a] * ru + Jv[a] * rv);
    acc[27] += w * (ru * ru + rv * rv);
  });
  red.sum(acc);
}

// One pose-only BA by the whole CTA on the thread's points; see pose_ba_cta.
template <bool kOne>
__device__ __forceinline__ void pose_ba_body(const Obs& o, const float* __restrict__ pose0,
                                             float* __restrict__ out, float* __restrict__ inl,
                                             float* __restrict__ wf, int N, float chi2_th,
                                             int rounds, int iters, float eps, Reducer& red) {
  const float huber_k = sqrtf(chi2_th);
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose0[9 + k];
  Points<kOne> pts(o, inl, wf, N);

  float chi2_out = 0.f;
  for (int round = 0; round < rounds; ++round) {
    float sigma0 = 1.f;
    if (round == 0) {
      float c = 0.f;
      pts.each([&](const Pt& p, float in, float) {
        float v0;
        point_rn(R, t, o, p, in, v0);
        c += v0;
      });
      const float half_cnt = 0.5f * pts.count(c, red);
      const float med = med_bisect(pts, R, t, 0.f, half_cnt, red);
      const float mad = med_bisect(pts, R, t, med, half_cnt, red);   // |rn - med|
      sigma0 = fmaxf(kMadScale * mad, 1.f);
    }
    pts.each([&](const Pt& p, float in, float& w_out) {
      float v0;
      const float rn = point_rn(R, t, o, p, in, v0);
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
      w_out = w * v0;
    });

    float ne[28];
    normal_eq(pts, R, t, ne, red);
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
      normal_eq(pts, Rn, tn, ne, red);   // ne is dead once dx is solved
      const bool worse = !(ne[27] <= chi2);  // a NaN trial counts as worse
      if (!worse) {
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
        chi2 = ne[27];
      }
      stop = worse || conv;
    }
    chi2_out = chi2;

    // Reclassify at the round's final pose; keep the old set if no point
    // passes.  The weight slot is free now and holds the new flag.
    float c = 0.f;
    pts.each([&](const Pt& p, float, float& w_out) {
      float ru, rv, Ju[6], Jv[6];
      const float valid = reproj(R, t, o, p, ru, rv, Ju, Jv);
      w_out = valid * (ru * ru + rv * rv < chi2_th ? 1.f : 0.f);
      c += w_out;
    });
    if (pts.count(c, red) > 0.5f) pts.each([](const Pt&, float& in, float w) { in = w; });
  }
  pts.publish();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[9 + k] = t[k];
    out[12] = chi2_out;
  }
}

// The block of K5 and K8: a thread per point in whole warps, at most
// kPoseBaThreads (128 registers a thread, no spill); more points loop.
constexpr int kPoseBaThreads = 512;

inline int pose_ba_threads(int N) {
  return N <= 32 ? 32 : N >= kPoseBaThreads ? kPoseBaThreads : (N + 31) / 32 * 32;
}

// One pose-only BA by the whole CTA (blockDim.x a multiple of 32): pose0
// [12] (R row-major, t) in, out [13] (R, t, last round's chi2) and inl [N]
// (0/1) out; wf [N] is scratch (used when N > blockDim.x).  Every block
// reduction goes through `red`.  Thread 0 writes out; each thread writes
// its own rows of inl.
__device__ __forceinline__ void pose_ba_cta(const Obs& o, const float* __restrict__ pose0,
                                            float* __restrict__ out, float* __restrict__ inl,
                                            float* __restrict__ wf, int N, float chi2_th,
                                            int rounds, int iters, float eps, Reducer& red) {
  if (N <= (int)blockDim.x)
    pose_ba_body<true>(o, pose0, out, inl, wf, N, chi2_th, rounds, iters, eps, red);
  else
    pose_ba_body<false>(o, pose0, out, inl, wf, N, chi2_th, rounds, iters, eps, red);
}

}  // namespace
