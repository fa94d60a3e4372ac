// K1, K2 and K6: integer-origin window gathers.
//
// Replace, in ygz_slam_tpu/ops/pallas/align2d_kernel.py:
//   K1 gather_windows          one [H, W] image, N windows; here also the L
//                              levels of one pyramid, N windows each, in
//                              one launch (gather_windows_levels);
//   K2 gather_windows_multi    an [S, H, W] stack (here also a table of images
//                              of their own shapes), an image index per window;
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
// batch path: 1600 windows of 32x32, 6.6 MB each way, a ~3.9 us byte bound;
// on the VO path 512 windows, ~1.25 us).  K1's and K6's launches are
// smaller still (a frame's three levels of 200 16x16 windows: 0.6 MB each
// way, ~0.2 us at 3.35 TB/s; the batch path's 8 sequences: ~2.9 us), so
// what such a launch costs is the launch itself, the ramp of its grid and
// one dependent chain (origin, pixel, store).  Their design for this card:
//   - one launch for every level of a pyramid (K1), for every level of
//     every sequence of a batched frame (K6: up to kMaxGroups requests, the
//     images, shapes and origins by value in a __grid_constant__ struct),
//     and for every window of a frame whatever its image (K2), where a
//     frame took one launch per level or per sequence;
//   - a warp per window, kWindowsPerBlock windows per block, so a frame's
//     windows are a few hundred blocks; each warp reads its (image,
//     origin) once (1 to 4 windows per block time alike on the H100, 8 to
//     32 slower: PERF.md); a K6 warp finds its request by a binary search
//     over the requests' first windows;
//   - the warp's lanes across a window row (`warp_window`, the one body of
//     all three gathers), so each row is one coalesced read and write, with
//     no division per pixel: where win % 4 == 0 and the output is 16-byte
//     aligned each lane copies 4 pixels of a row and stores them as one
//     128-bit store (the source rows are not aligned); K6 decides this per
//     request, so alike for every lane of a warp;
//   - a lane issues all its loads of a window (up to 8 warp steps of
//     rows) before its first store, so they wait on one memory latency,
//     not one per step;
//   - zero fill outside the image, as before.
// K2 names its images in one of two ways, with one kernel body: a uniform
// [S, H, W] stack (base pointer and shape, any S: the batch path's
// sequences), or a table of up to kMaxLevels images of their own shapes
// passed by value (the VO's pyramid levels, read in place: the window of
// the zero-padded level is the window of the zero-padded stack that the
// TPU kernel needed, bit for bit, so no stack is built).  A form on the
// card's TMA (a tensor map per image, zero fill out of bounds, one box per
// window into shared memory) was timed against this body and lost at
// every shape of the paths (PERF.md); its box must start on a 16-byte
// column, so it loaded win + 4 columns and still needed the warp's copy.
#include <cassert>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 64;     // ops/kernels/align2d_kernel.py MAX_GROUPS

// One window's copy by one warp, the body of K1, K2 and K6: the [win, win]
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

__host__ __device__ inline bool vectorised(int win, const float* out) {
  return win % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
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
  if (vectorised(q.win, q.out))
    warp_window<true>(q.img, q.H, q.W, q.ox[n], q.oy[n], q.win, dst, lane);
  else
    warp_window<false>(q.img, q.H, q.W, q.ox[n], q.oy[n], q.win, dst, lane);
}

}  // namespace

// One image of a K1 launch or of K2's table.  The layout is mirrored by a
// ctypes.Structure in ops/kernels/align2d_kernel.py: a pointer, then two
// ints.
struct LevelImage {
  const float* img;
  int H, W;
};

namespace {

constexpr int kMaxLevels = 8;      // ops/kernels/align2d_kernel.py MAX_LEVELS

// K1's levels, and K2's table of images of their own shapes.
struct LevelsArgs {
  LevelImage lv[kMaxLevels];
  int L;
  __device__ int count() const { return L; }
  __device__ LevelImage at(int s) const { return lv[s]; }
};

// K2's uniform stack: S images of H x W, one after another from `base`.
struct StackArgs {
  const float* base;
  int S, H, W;
  __device__ int count() const { return S; }
  __device__ LevelImage at(int s) const {
    return LevelImage{base + (size_t)s * H * W, H, W};
  }
};

LevelsArgs levels_args(const LevelImage* levels, int L) {
  LevelsArgs a;
  a.L = L;
  for (int l = 0; l < L; ++l) a.lv[l] = levels[l];
  for (int l = L; l < kMaxLevels; ++l) a.lv[l] = LevelImage{nullptr, 0, 0};
  return a;
}

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

// Window n of a K2 launch is written by warp n, from image img_idx[n] of
// the stack or the table.  An index outside [0, count) names no image: the
// kernel stops on a device-side assert (the caller's next synchronisation
// raises) instead of reading past the images.  The plain version raises
// IndexError.
template <bool kVec, class Images>
__global__ void __launch_bounds__(32 * kWindowsPerBlock)
gather_windows_multi_kernel(const __grid_constant__ Images im, const int* __restrict__ img_idx,
                            const int* __restrict__ ox, const int* __restrict__ oy, int N,
                            int win, float* __restrict__ out) {
  const int n = blockIdx.x * kWindowsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const int s = img_idx[n];
  assert(s >= 0 && s < im.count());
  if (s < 0 || s >= im.count()) return;
  const LevelImage q = im.at(s);
  warp_window<kVec>(q.img, q.H, q.W, ox[n], oy[n], win, out + (size_t)n * win * win,
                    threadIdx.x & 31);
}

template <class Images>
int launch_multi(const Images& im, const int* img_idx, const int* ox, const int* oy, int N,
                 int win, float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int blocks = (N + kWindowsPerBlock - 1) / kWindowsPerBlock;
  if (vectorised(win, out))
    gather_windows_multi_kernel<true, Images><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(
        im, img_idx, ox, oy, N, win, out);
  else
    gather_windows_multi_kernel<false, Images><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(
        im, img_idx, ox, oy, N, win, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: the [L, N, win, win] windows of L images (levels[l], origins ox / oy
// [L, N]) in one launch.
extern "C" int gather_windows_levels_launch(const LevelImage* levels, int L, const int* ox,
                                            const int* oy, int N, int win, float* out,
                                            cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const LevelsArgs a = levels_args(levels, L);
  const int blocks = (L * N + kWindowsPerBlock - 1) / kWindowsPerBlock;
  if (vectorised(win, out))
    gather_levels_kernel<true><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(a, ox, oy, N, win,
                                                                           out);
  else
    gather_levels_kernel<false><<<blocks, 32 * kWindowsPerBlock, 0, stream>>>(a, ox, oy, N,
                                                                            win, out);
  return (int)cudaGetLastError();
}

// K2 over a uniform [S, H, W] stack: window n of image img_idx[n].
extern "C" int gather_windows_multi_launch(const float* imgs, int S, int H, int W,
                                           const int* img_idx, const int* ox, const int* oy,
                                           int N, int win, float* out, cudaStream_t stream) {
  return launch_multi(StackArgs{imgs, S, H, W}, img_idx, ox, oy, N, win, out, stream);
}

// K2 over a table of L (1..kMaxLevels) images of their own shapes.
extern "C" int gather_windows_multi_levels_launch(const LevelImage* levels, int L,
                                                  const int* img_idx, const int* ox,
                                                  const int* oy, int N, int win, float* out,
                                                  cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  return launch_multi(levels_args(levels, L), img_idx, ox, oy, N, win, out, stream);
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
