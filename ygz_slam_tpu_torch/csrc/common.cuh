// Device helpers shared by the Gauss-Newton kernels (K3, K5, K8, K9,
// K11): block-wide sums whose totals every thread receives bit for bit
// alike, a damped 6x6 Cholesky solve with a non-finite guard (and K9 v2's
// factor rule), and the
// Taylor-series SE(3) exponential of the JAX kernels (same coefficients,
// same 1.2 rad trust clamp); and the launch of a thread-block cluster (K9
// v1, K11).
#pragma once

#include <cuda_runtime.h>

namespace ygz {

constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
// Shared floats a Reducer needs: two buffers of kMaxWarps x 32 partials.
constexpr int kRedFloats = 2 * kMaxWarps * 32;
constexpr int kMaxCluster = 8;       // the portable cluster size

// Launches `kernel` as one thread-block cluster of `cluster` CTAs of
// `threads` threads (the grid is the cluster), CTA r taking items
// [r * per_cta, min(n, (r + 1) * per_cta)) (the wrapper's
// ops/kernels/__init__.py::cluster_partition).  Returns the launch's CUDA error: a
// cluster outside 1..kMaxCluster, or ranges that leave an item out, are
// refused, and a refused launch is not retried with a smaller cluster.  No
// non-portable cluster size is allowed.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, int per_cta, int n,
                                  int threads, cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster || (long long)cluster * per_cta < n)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One halving step of the transposed warp reduction and the steps after
// it, on the N values v[0..N) with lane offset OFF: a lane keeps the half
// of its values its partner (lane ^ OFF) does not and adds the partner's
// copy of them (N / 2 shuffles).  N and OFF are template arguments, so
// every index is a constant and v stays in registers.
template <int N, int OFF>
__device__ __forceinline__ void halve(float* v, int lane) {
  if constexpr (N > 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? v[j] : v[j + N / 2];
      const float keep = upper ? v[j + N / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    halve<N / 2, OFF / 2>(v, lane);
  }
}

// Transposed warp reduction of KP values (KP a power of two <= 32): a
// reduce-scatter by recursive halving (KP/2 + KP/4 + ... + 1 shuffles),
// then a butterfly over the lanes that hold the same value.  Returns the
// warp total of value lane / (32 / KP); every lane that holds one value
// holds the same bits (a + b == b + a).
template <int KP>
__device__ __forceinline__ float warp_scatter_sum(float (&v)[KP]) {
  const int lane = threadIdx.x & 31;
  halve<KP, 16>(v, lane);
  float x = v[0];
#pragma unroll
  for (int off = 16 / KP; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The least power of two >= K (K <= 32).
template <int K>
struct Pow2AtLeast {
  static constexpr int value =
      K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;
};

// Block-wide reductions for a CTA whose blockDim.x is a multiple of 32.
// Each is one transposed warp reduction, one __syncthreads() and one pass
// of each warp over the warps' partials (value k summed by lane k, warp 0
// first), then a broadcast by shuffle: the sums come out in a fixed
// order, identical in every thread, so every thread takes the same branch
// on them and a launch repeats bit for bit.  The partials alternate
// between two buffers: a reduction writes its buffer only after the
// previous reduction's barrier, which every warp passes only after it has
// read the buffer of the one before.  So all block reductions of a kernel
// go through one Reducer, and nothing else writes its shared memory.
class Reducer {
 public:
  __device__ explicit Reducer(float* smem) : smem_(smem) {}

  // v[k] <- the sum of v[k] over the block, for k < K <= 32.
  template <int K>
  __device__ __forceinline__ void sum(float (&v)[K]) {
    constexpr int KP = Pow2AtLeast<K>::value;
    static_assert(K <= 32, "at most 32 values per reduction");
    float w[KP];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = v[k];
#pragma unroll
    for (int k = K; k < KP; ++k) w[k] = 0.f;
    const float x = warp_scatter_sum<KP>(w);
    const float tot = across_warps<KP>(x, false);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kFull, tot, k);
  }

  // The block's maximum of v (fmaxf: a NaN loses to a number).
  __device__ __forceinline__ float max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return __shfl_sync(kFull, across_warps<1>(v, true), 0);
  }

 private:
  // Lane 0 of each value's lanes publishes the warp's partial; after the
  // barrier, lane k < KP of every warp combines value k over the warps.
  template <int KP>
  __device__ __forceinline__ float across_warps(float x, bool take_max) {
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    constexpr int G = 32 / KP;             // lanes holding one value
    float* buf = smem_ + flip_ * (kMaxWarps * 32);
    flip_ ^= 1;
    if (lane % G == 0) buf[(threadIdx.x >> 5) * KP + lane / G] = x;
    __syncthreads();
    float tot = 0.f;
    if (lane < KP) {
      tot = buf[lane];
      for (int w = 1; w < nwarps; ++w)
        tot = take_max ? fmaxf(tot, buf[w * KP + lane]) : tot + buf[w * KP + lane];
    }
    return tot;
  }

  float* smem_;
  int flip_ = 0;
};

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

// K9 v2's factor of the frozen H0, the rule of the JAX package's v2
// (ops/kernels/sparse_align_fused.py::frozen_factor): cholesky(H0 + 1e-8 I)
// with no pivot floor; the identity when a pivot is not positive (or NaN),
// and any non-finite entry replaced by the identity's.
__device__ __forceinline__ void chol6_frozen(const float h[21], float L[6][6]) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) { A[a][b] = h[k]; A[b][a] = h[k]; ++k; }
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[j][j] + 1e-8f;
#pragma unroll
    for (int q = 0; q < j; ++q) d -= L[j][q] * L[j][q];
    ok = ok && d > 0.f;                  // false for NaN
    const float ljj = sqrtf(d);
    L[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s -= L[i][q] * L[j][q];
      L[i][j] = s / ljj;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int q = 0; q <= i; ++q) {
      const float id = i == q ? 1.f : 0.f;
      L[i][q] = ok && isfinite(L[i][q]) ? L[i][q] : id;
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
