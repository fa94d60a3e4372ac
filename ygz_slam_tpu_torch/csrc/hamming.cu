// K10: all-pairs Hamming distance over packed 256-bit descriptors.
//
// Replaces distance_matrix_pallas in
// ygz_slam_tpu/ops/pallas/hamming_kernel.py: a [N, 8] and b [M, 8] 32-bit
// words -> out [N, M] int32, out[n, m] = sum_w popcount(a[n, w] ^ b[m, w]).
// The TPU kernel pads both sides to 128-row tiles and counts bits with a
// SWAR reduction, because Mosaic wants tile-aligned blocks and the TPU has
// no popcount instruction.  Neither is carried over: the grid covers ragged
// edges with bounds checks, and __popc is one instruction.
//
// Layout: a 2-D grid of [kTileN, kTileM] output tiles.  Each thread owns one
// column m of the tile and keeps b[m] (8 words) in registers; the block
// stages the tile's kTileN rows of `a` in shared memory, which every thread
// reads at the same address (a broadcast, no bank conflict).  For each row
// the threads of a warp write 32 consecutive ints of out[n, :], so the
// stores are coalesced along M.
//
// Bound: bytes.  (N + M) * 32 bytes in, N * M * 4 bytes out; the output
// dominates (256 x 3072: 3.1 MB), a microsecond at the card's memory rate.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileM = 128;   // columns per block = threads per block
constexpr int kTileN = 32;    // rows per block

__global__ void hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               int N, int M, int* __restrict__ out) {
  __shared__ uint32_t sa[kTileN * kWords];
  const int n0 = blockIdx.y * kTileN;
  const int rows = min(kTileN, N - n0);
  for (int k = threadIdx.x; k < rows * kWords; k += blockDim.x)
    sa[k] = a[(size_t)n0 * kWords + k];
  __syncthreads();
  const int m = blockIdx.x * kTileM + threadIdx.x;
  if (m >= M) return;
  uint32_t br[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) br[w] = b[(size_t)m * kWords + w];
  for (int r = 0; r < rows; ++r) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d += __popc(sa[r * kWords + w] ^ br[w]);
    out[(size_t)(n0 + r) * M + m] = d;
  }
}

}  // namespace

extern "C" int hamming_launch(const int* a, const int* b, int N, int M, int* out,
                              cudaStream_t stream) {
  if (N <= 0 || M <= 0) return 0;
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  hamming_kernel<<<grid, kTileM, 0, stream>>>(reinterpret_cast<const uint32_t*>(a),
                                              reinterpret_cast<const uint32_t*>(b), N, M, out);
  return (int)cudaGetLastError();
}
