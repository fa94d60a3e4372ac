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
// is a few microseconds.  K1's launches are smaller still (a frame's three
// levels of 200 16x16 windows: 0.6 MB each way, ~0.2 us at 3.35 TB/s), so
// what a K1 launch costs is the launch itself, the ramp of its grid and
// one dependent chain (origin, pixel, store).  Its design for this card:
//   - one launch for every level of a pyramid (the levels' images and
//     shapes by value in a __grid_constant__ struct), where a frame took
//     one launch per level;
//   - a warp per window, kWindowsPerBlock windows per block, so a frame's
//     L * N windows are a few hundred blocks; each warp reads its (level,
//     origin) once (1 to 4 windows per block time alike on the H100, 8 to
//     32 slower: PERF.md);
//   - the warp's lanes across a window row, so each row is one coalesced
//     read and write, with no division per pixel: for win 16 and 32 each
//     lane copies 4 pixels of a row and stores them as one 128-bit store
//     (the output rows are 16-byte aligned, the source rows are not);
//   - a lane issues all its loads of a window (up to 8 warp steps of
//     rows) before its first store, so they wait on one memory latency,
//     not one per step;
//   - zero fill outside the image, as before.
// K2 and K6 keep one block per window, threads over its pixels.
#include <cassert>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 8;

// Copies the [win, win] window of the zero-padded [H, W] image at origin
// (x0, y0) into dst.
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

// Every group's descriptor, passed to the kernel by value; start[g] is the
// first block of group g.
struct GroupedArgs {
  GatherGroup g[kMaxGroups];
  int start[kMaxGroups + 1];
  int G;
};

__global__ void gather_windows_grouped_kernel(const __grid_constant__ GroupedArgs a) {
  const int b = blockIdx.x;
  int g = 0;
  while (g + 1 < a.G && b >= a.start[g + 1]) ++g;
  const GatherGroup& q = a.g[g];
  const int n = b - a.start[g];
  copy_window(q.img, q.H, q.W, q.ox[n], q.oy[n], q.win, q.out + (size_t)n * q.win * q.win);
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
constexpr int kWindowsPerBlock = 4;     // warps per block, a window each

struct LevelsArgs {
  LevelImage lv[kMaxLevels];
  int L;
};

// Window g of a K1 launch (level g / N, point g % N) is written by warp g.
// kVec: win % 4 == 0, each lane copies 4 pixels of a row into one float4.
// A row is `units` lane units (a pixel, or 4 pixels under kVec); a warp
// step covers `rows` rows, lane (dr, c) unit c of row dr of the step.  A
// lane loads up to kSteps steps' units before it stores any (a 32x32
// window is 8 steps), so its loads are in flight together.
constexpr int kSteps = 8;

template <bool kVec>
__global__ void __launch_bounds__(1024)
gather_levels_kernel(const __grid_constant__ LevelsArgs a,
                     const int* __restrict__ ox, const int* __restrict__ oy, int N, int win,
                     float* __restrict__ out) {
  using Unit = typename std::conditional<kVec, float4, float>::type;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= a.L * N) return;
  const LevelImage q = a.lv[g / N];
  const int x0 = ox[g], y0 = oy[g];
  Unit* dst = reinterpret_cast<Unit*>(out + (size_t)g * win * win);
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
        const bool yin = r0 + j * rows < win && y >= 0 && y < q.H;
        const float* src = q.img + (size_t)(yin ? y : 0) * q.W;
        if constexpr (kVec) {
          v[j].x = (yin && x >= 0 && x < q.W) ? __ldg(src + x) : 0.f;
          v[j].y = (yin && x + 1 >= 0 && x + 1 < q.W) ? __ldg(src + x + 1) : 0.f;
          v[j].z = (yin && x + 2 >= 0 && x + 2 < q.W) ? __ldg(src + x + 2) : 0.f;
          v[j].w = (yin && x + 3 >= 0 && x + 3 < q.W) ? __ldg(src + x + 3) : 0.f;
        } else {
          v[j] = (yin && x >= 0 && x < q.W) ? __ldg(src + x) : 0.f;
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

extern "C" int gather_windows_grouped_launch(const GatherGroup* groups, int G,
                                             cudaStream_t stream) {
  if (G < 1 || G > kMaxGroups) return (int)cudaErrorInvalidValue;
  GroupedArgs a;
  a.G = G;
  a.start[0] = 0;
  int max_win = 1;
  for (int g = 0; g < G; ++g) {
    a.g[g] = groups[g];
    a.start[g + 1] = a.start[g] + groups[g].N;
    max_win = groups[g].win > max_win ? groups[g].win : max_win;
  }
  for (int g = G; g < kMaxGroups; ++g) a.start[g + 1] = a.start[G];
  if (a.start[G] <= 0) return 0;
  gather_windows_grouped_kernel<<<a.start[G], threads_for(max_win), 0, stream>>>(a);
  return (int)cudaGetLastError();
}
