// K1, K2 and K6: integer-origin window gathers.
//
// Replace, in ygz_slam_tpu/ops/pallas/align2d_kernel.py:
//   K1 gather_windows          one [H, W] image, N windows;
//   K2 gather_windows_multi    an [S, H, W] stack, an image index per window;
//   K6 gather_windows_grouped  up to kMaxGroups requests (image, origins,
//                              window size) with different images and sizes,
//                              in one launch.
// The TPU kernels fetch 8/128-aligned super-windows and shift them with
// one-hot matmuls, because Mosaic's slices must start on a tile.  What
// they return is the window of the zero-padded image at the requested
// origin: pixels inside the image are copied, the rest are 0.  On Hopper a
// window read is an ordinary indexed load, so all three kernels share one
// device body that copies a window with that zero fill: one block per
// window, threads over its pixels.
//
// Bound: bytes.  Each window is read once and written once (K2 on the
// batch path: 1600 windows of 32x32, 6.6 MB each way), so the byte bound
// is a few microseconds; the kernels keep each window row's reads and
// writes coalesced and do no arithmetic beyond indexing.
#include <cassert>

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

__global__ void gather_windows_kernel(const float* __restrict__ img, int H, int W,
                                      const int* __restrict__ ox,
                                      const int* __restrict__ oy, int win,
                                      float* __restrict__ out) {
  const int n = blockIdx.x;
  copy_window(img, H, W, ox[n], oy[n], win, out + (size_t)n * win * win);
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

extern "C" int gather_windows_launch(const float* img, int H, int W, const int* ox,
                                     const int* oy, int N, int win, float* out,
                                     cudaStream_t stream) {
  if (N <= 0) return 0;
  gather_windows_kernel<<<N, threads_for(win), 0, stream>>>(img, H, W, ox, oy, win, out);
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
