// K1: integer-origin window gather.
//
// Replaces ygz_slam_tpu/ops/pallas/align2d_kernel.py::gather_windows
// (the PrefetchScalarGridSpec copy of 8/128-aligned super-windows plus
// the one-hot shift matmuls that Mosaic's aligned-slice rule forced).
// On Hopper a window read is an ordinary indexed load, so the kernel
// copies each [win, win] window directly: one block per point, threads
// over the window's pixels, origins clamped to [0, H-win] x [0, W-win].
//
// Bound: bytes.  It moves N*win*win*4 bytes in and out (200 windows of
// 32x32 = 0.8 MB each way), a fraction of a microsecond at 3.35 TB/s, so
// in practice its time is the launch.  The design keeps the copy fully
// coalesced along window rows and does no arithmetic beyond indexing.
#include <cuda_runtime.h>

namespace {

__global__ void gather_windows_kernel(const float* __restrict__ img, int H, int W,
                                      const int* __restrict__ ox,
                                      const int* __restrict__ oy, int win,
                                      float* __restrict__ out) {
  const int n = blockIdx.x;
  const int x0 = min(max(ox[n], 0), W - win);
  const int y0 = min(max(oy[n], 0), H - win);
  const float* src = img + (size_t)y0 * W + x0;
  float* dst = out + (size_t)n * win * win;
  for (int k = threadIdx.x; k < win * win; k += blockDim.x) {
    const int r = k / win;
    const int c = k - r * win;
    dst[k] = src[(size_t)r * W + c];
  }
}

}  // namespace

extern "C" int gather_windows_launch(const float* img, int H, int W, const int* ox,
                                     const int* oy, int N, int win, float* out,
                                     cudaStream_t stream) {
  if (N <= 0) return 0;
  const int pix = win * win;
  const int threads = pix >= 256 ? 256 : ((pix + 31) / 32) * 32;
  gather_windows_kernel<<<N, threads, 0, stream>>>(img, H, W, ox, oy, win, out);
  return (int)cudaGetLastError();
}
