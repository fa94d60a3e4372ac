// K1, K2 and K6: integer-origin window gathers.
//
// Replace, in ygz_slam_tpu/ops/pallas/align2d_kernel.py:
//   K1 gather_windows          one [H, W] image, N windows; here also the L
//                              levels of one pyramid, N windows each, in
//                              one launch (gather_windows_levels);
//   K2 gather_windows_multi    an [S, H, W] stack, an image index per window;
//   K6 gather_windows_grouped  up to kMaxGroups requests (image, origins,
//                              window size) with different images and sizes,
//                              in one launch.
// The TPU kernels fetch 8/128-aligned super-windows and shift them with
// one-hot matmuls, because Mosaic's slices must start on a tile.  What
// they return is the window of the zero-padded image at the requested
// origin: pixels inside the image are copied, the rest are 0.  On Hopper a
// window read is an ordinary indexed load.
//
// Bound: bytes.  Each window is read once and written once (K2 on the
// batch path: 1600 windows of 32x32, 6.6 MB each way), so the byte bound
// is a few microseconds.  K1's and K6's launches are smaller still (a
// frame's three levels of 200 16x16 windows: 0.6 MB each way, ~0.2 us at
// 3.35 TB/s; the batch path's 8 sequences: ~2.9 us), so what such a launch
// costs is the launch itself, the ramp of its grid and one dependent chain
// (origin, pixel, store).  Their design for this card:
//   - one launch for every level of a pyramid (K1), and for every level of
//     every sequence of a batched frame (K6: up to kMaxGroups requests, the
//     images, shapes and origins by value in a __grid_constant__ struct),
//     where a frame took one launch per level or per sequence;
//   - a warp per window, kWindowsPerBlock windows per block, so a frame's
//     windows are a few hundred blocks; each warp reads its (level or
//     request, origin) once (1 to 4 windows per block time alike on the
//     H100, 8 to 32 slower: PERF.md); a K6 warp finds its request by a
//     binary search over the requests' first windows;
//   - the warp's lanes across a window row (`warp_window`, the body K1 and
//     K6 share), so each row is one coalesced read and write, with no
//     division per pixel: where win % 4 == 0 and the output is 16-byte
//     aligned each lane copies 4 pixels of a row and stores them as one
//     128-bit store (the source rows are not aligned); K6 decides this per
//     request, so alike for every lane of a warp;
//   - a lane issues all its loads of a window (up to 8 warp steps of
//     rows) before its first store, so they wait on one memory latency,
//     not one per step;
//   - zero fill outside the image, as before.
// K2 keeps one block per window, threads over its pixels (`copy_window`).
#include <cassert>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 64;     // ops/kernels/align2d_kernel.py MAX_GROUPS

// K2's body: the block's threads copy the [win, win] window of the
// zero-padded [H, W] image at origin (x0, y0) into dst.
__device__ __forceinline__ void copy_window(const float* __restrict__ img, int H, int W,
                                            int x0, int y0, int win,
                                            float* __restrict__ dst) {
  for (int k = threadIdx.x; k < win * win; k += blockDim.x) {
    const int r = k / win;
    const int c = k - r * win;
    const int y = y0 + r;
    const int x = x0 + c;
    dst[k] = (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.f;
  }
}

int threads_for(int win) {
  const int pix = win * win;
  return pix >= 256 ? 256 : ((pix + 31) / 32) * 32;
}

// An image index outside [0, S) names no image of the stack: the kernel
// stops on a device-side assert (the caller's next synchronisation raises)
// instead of reading past the stack.  The plain version raises IndexError.
__global__ void gather_windows_multi_kernel(const float* __restrict__ imgs, int S, int H,
                                            int W, const int* __restrict__ img_idx,
                                            const int* __restrict__ ox,
                                            const int* __restrict__ oy, int win,
                                            float* __restrict__ out) {
  const int n = blockIdx.x;
  const int s = img_idx[n];
  assert(s >= 0 && s < S);
  if (s < 0 || s >= S) return;
  copy_window(imgs + (size_t)s * H * W, H, W, ox[n], oy[n], win, out + (size_t)n * win * win);
}

// One window's copy by one warp, the body K1 and K6 share: the [win, win]
// window of the zero-padded [H, W] image at origin (x0, y0) into dst.
// kVec: win % 4 == 0 and dst 16-byte aligned, each lane copies 4 pixels of
// a row into one float4.  A row is `units` lane units (a pixel, or 4
// pixels under kVec); a warp step covers `rows` rows, lane (dr, c) unit c
// of row dr of the step.  A lane loads up to kSteps steps' units before it
// stores any (a 32x32 window is 8 steps), so its loads are in flight
// together.
constexpr int kSteps = 8;
constexpr int kWindowsPerBlock = 4;     // warps per block, a window each

template <bool kVec>
__device__ __forceinline__ void warp_window(const float* __restrict__ img, int H, int W,
                                            int x0, int y0, int win,
                                            float* __restrict__ out, int lane) {
  using Unit = typename std::conditional<kVec, float4, float>::type;
  Unit* dst = reinterpret_cast<Unit*>(out);
  const int units = kVec ? win >> 2 : win;
  const int rows = units <= 32 ? 32 / units : 1;
  const int dr = units <= 32 ? lane / units : 0;
  if (dr >= rows) return;
  const int c0 = lane - dr * (units <= 32 ? units : 0);
  const int cstep = units <= 32 ? units : 32;
  for (int c = c0; c < units; c += cstep) {
    const int x = x0 + (kVec ? 4 * c : c);
    for (int r0 = dr; r0 < win; r0 += kSteps * rows) {
      Unit v[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int y = y0 + r0 + j * rows;
        const bool yin = r0 + j * rows < win && y >= 0 && y < H;
        const float* src = img + (size_t)(yin ? y : 0) * W;
        if constexpr (kVec) {
          v[j].x = (yin && x >= 0 && x < W) ? __ldg(src + x) : 0.f;
          v[j].y = (yin && x + 1 >= 0 && x + 1 < W) ? __ldg(src + x + 1) : 0.f;
          v[j].z = (yin && x + 2 >= 0 && x + 2 < W) ? __ldg(src + x + 2) : 0.f;
          v[j].w = (yin && x + 3 >= 0 && x + 3 < W) ? __ldg(src + x + 3) : 0.f;
        } else {
          v[j] = (yin && x >= 0 && x < W) ? __ldg(src + x) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int r = r0 + j * rows;
        if (r < win) dst[(size_t)r * units + c] = v[j];
      }
    }
  }
}

}  // namespace

// One K6 request.  The layout is mirrored by a ctypes.Structure in
// ops/kernels/align2d_kernel.py: four pointers, then four ints.
struct GatherGroup {
  const float* img;
  const int* ox;
  const int* oy;
  float* out;
  int H, W, N, win;
};

namespace {

// Every request's descriptor, passed to the kernel by value (64 x 48 B +
// the offsets: under the 4 KB parameter limit); start[g] is the first
// window of request g, start[G] the launch's window count.
struct GroupedArgs {
  GatherGroup g[kMaxGroups];
  int start[kMaxGroups + 1];
  int G;
};

// Window w of a K6 launch is written by warp w: the last request g with
// start[g] <= w (empty requests own no window), its window w - start[g].
__global__ void __launch_bounds__(32 * kWindowsPerBlock)
gather_windows_grouped_kernel(const __grid_constant__ GroupedArgs a) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWindowsPerBlock + (threadIdx.x >> 5);
  if (w >= a.start[a.G]) return;
  int lo = 0, hi = a.G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.start[mid] <= w) lo = mid;
    else hi = mid - 1;
  }
  const GatherGroup& q = a.g[lo];
  const int n = w - a.start[lo];
  float* dst = q.out + (size_t)n * q.win * q.win;
  if (q.win % 4 == 0 && reinterpret_cast<size_t>(q.out) % 16 == 0)
    warp_window<true>(q.img, q.H, q.W, q.ox[n], q.oy[n], q.win, dst, lane);
  else
    warp_window<false>(q.img, q.H, q.W, q.ox[n], q.oy[n], q.win, dst, lane);
}

}  // namespace

// One level of a K1 launch.  The layout is mirrored by a ctypes.Structure
// in ops/kernels/align2d_kernel.py: a pointer, then two ints.
struct LevelImage {
  const float* img;
  int H, W;
};

namespace {

constexpr int kMaxLevels = 8;

struct LevelsArgs {
  LevelImage lv[kMaxLevels];
  int L;
};

// Window g of a K1 launch (level g / N, point g % N) is written by warp g.
template <bool kVec>
__global__ void __launch_bounds__(1024)
gather_levels_kernel(const __grid_constant__ LevelsArgs a,
                     const int* __restrict__ ox, const int* __restrict__ oy, int N, int win,
                     float* __restrict__ out) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= a.L * N) return;
  const LevelImage q = a.lv[g / N];
  warp_window<kVec>(q.img, q.H, q.W, ox[g], oy[g], win, out + (size_t)g * win * win,
                    threadIdx.x & 31);
}

}  // namespace

// K1: the [L, N, win, win] windows of L images (levels[l], origins ox / oy
// [L, N]) in one launch.
extern "C" int gather_windows_levels_launch(const LevelImage* levels, int L, const int* ox,
                                            const int* oy, int N, int win, float* out,
                                            cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  LevelsArgs a;
  a.L = L;
  for (int l = 0; l < L; ++l) a.lv[l] = levels[l];
  for (int l = L; l < kMaxLevels; ++l) a.lv[l] = LevelImage{nullptr, 0, 0};
  const int blocks = (L * N + kWindowsPerBlock - 1) / kWindowsPerBlock;
  const bool vec = win % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec)
    gather_levels_kernel<true><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(a, ox, oy, N, win,
                                                                           out);
  else
    gather_levels_kernel<false><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(a, ox, oy, N,
                                                                            win, out);
  return (int)cudaGetLastError();
}

extern "C" int gather_windows_multi_launch(const float* imgs, int S, int H, int W,
                                           const int* img_idx, const int* ox, const int* oy,
                                           int N, int win, float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  gather_windows_multi_kernel<<<N, threads_for(win), 0, stream>>>(imgs, S, H, W, img_idx, ox,
                                                                  oy, win, out);
  return (int)cudaGetLastError();
}

// K6: G requests (1..kMaxGroups), each request's [N, win, win] windows into
// its own output, in one launch.
extern "C" int gather_windows_grouped_launch(const GatherGroup* groups, int G,
                                             cudaStream_t stream) {
  if (G < 1 || G > kMaxGroups) return (int)cudaErrorInvalidValue;
  GroupedArgs a;
  a.G = G;
  a.start[0] = 0;
  for (int g = 0; g < G; ++g) {
    a.g[g] = groups[g];
    a.start[g + 1] = a.start[g] + groups[g].N;
  }
  for (int g = G; g < kMaxGroups; ++g) {
    a.g[g] = GatherGroup{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
    a.start[g + 1] = a.start[G];
  }
  if (a.start[G] <= 0) return 0;
  const int blocks = (a.start[G] + kWindowsPerBlock - 1) / kWindowsPerBlock;
  gather_windows_grouped_kernel<<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
