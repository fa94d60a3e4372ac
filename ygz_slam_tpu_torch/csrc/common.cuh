// Device helpers shared by the single-CTA Gauss-Newton kernels
// (sparse_align_mega.cu, pose_ba_fused.cu): block-wide sums whose totals
// every thread receives in the same order, a damped 6x6 Cholesky solve
// with a non-finite guard, and the Taylor-series SE(3) exponential of
// the JAX kernels (same coefficients, same 1.2 rad trust clamp).
#pragma once

#include <cuda_runtime.h>

namespace ygz {

constexpr int kMaxWarps = 32;

// Sums K per-thread values over the block.  blockDim.x must be a
// multiple of 32.  smem holds kMaxWarps * K floats.  On return every
// thread holds the same K totals, summed warp by warp in a fixed order,
// so every thread takes the same branch on them afterwards.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) smem[warp * K + k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += smem[w * K + k];
    v[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float m = smem[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, smem[w]);
  __syncthreads();
  return m;
}

// Cholesky of the 21-entry upper-triangular 6x6 H (row-major a<=b) with
// the 1e-8 diagonal damping and 1e-20 pivot floor of the JAX solvers.
__device__ __forceinline__ void chol6(const float h[21], float L[6][6]) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) { A[a][b] = h[k]; A[b][a] = h[k]; ++k; }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[j][j] + 1e-8f;
#pragma unroll
    for (int q = 0; q < j; ++q) d -= L[j][q] * L[j][q];
    const float ljj = sqrtf(fmaxf(d, 1e-20f));
    L[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s -= L[i][q] * L[j][q];
      L[i][j] = s / ljj;
    }
  }
}

// Forward/back substitution L L^T dx = b.  A step with any non-finite or
// |.| >= 1e9 entry becomes zero (the guard of solvers.nlls._solve_spd).
__device__ __forceinline__ void subst6(const float L[6][6], const float b[6], float dx[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * dx[q];
    dx[i] = s / L[i][i];
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && (fabsf(dx[i]) < 1e9f);  // false for NaN
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = 0.f;
  }
}

__device__ __forceinline__ void solve6(const float h[21], const float b[6], float dx[6]) {
  float L[6][6];
  chol6(h, L);
  subst6(L, b, dx);
}

// exp(dx) for dx = (rho, phi): rotation Re (row-major) and translation
// te, by the sqrt-free Taylor series in theta^2 with the step clamped to
// theta <= 1.2 rad.
__device__ __forceinline__ void exp_se3_taylor(const float dx[6], float Re[9], float te[3]) {
  const float t2 = dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5];
  const float theta = sqrtf(fmaxf(t2, 1e-24f));
  const float sc = fminf(1.f, 1.2f / theta);
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = dx[i] * sc;
  const float tt = t2 * sc * sc;
  const float a = 1.f - tt / 6.f * (1.f - tt / 20.f * (1.f - tt / 42.f * (1.f - tt / 72.f)));
  const float b = 0.5f * (1.f - tt / 12.f * (1.f - tt / 30.f * (1.f - tt / 56.f * (1.f - tt / 90.f))));
  const float c = (1.f / 6.f) * (1.f - tt / 20.f * (1.f - tt / 42.f * (1.f - tt / 72.f * (1.f - tt / 110.f))));
  const float wx = d[3], wy = d[4], wz = d[5];
  const float W[9] = {0.f, -wz, wy, wz, 0.f, -wx, -wy, wx, 0.f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) acc += W[3 * i + q] * W[3 * q + j];
      W2[3 * i + j] = acc;
    }
  const float eye[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float V[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    Re[i] = eye[i] + a * W[i] + b * W2[i];
    V[i] = eye[i] + b * W[i] + c * W2[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    te[i] = V[3 * i + 0] * d[0] + V[3 * i + 1] * d[1] + V[3 * i + 2] * d[2];
}

}  // namespace ygz
