// K10: all-pairs Hamming distance over packed 256-bit descriptors.
//
// Replaces distance_matrix_pallas in
// ygz_slam_tpu/ops/pallas/hamming_kernel.py: a [N, 8] and b [M, 8] 32-bit
// words -> out [N, M] int32, out[n, m] = sum_w popcount(a[n, w] ^ b[m, w]).
// The TPU kernel pads both sides to 128-row tiles and counts bits with a
// SWAR reduction, because Mosaic wants tile-aligned blocks and the TPU has
// no popcount instruction.  Neither is carried over: the grid covers ragged
// edges with predicated loads and guarded stores.
//
// Bound.  Bytes: (N + M) * 32 in, N * M * 4 out; the output dominates (the
// keyframe cycle's fusion matrix, 256 x 3072: 3.1 MB, ~0.94 us at 3.35
// TB/s).  Operations: 8 XOR + popcount + add per output.  On CUDA cores
// __popc issues at 16 per SM per clock, an eighth of the float32 rate, so
// 256 x 3072 x 8 = 6.3 M popcounts take ~1.5 us over the 132 SMs: longer
// than the bytes.  The tensor cores count bits far faster: a descriptor is
// 256 bits, the K of one single-bit MMA,
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc,
// which gives c = popc(a & b) for a 16 x 8 tile of pairs in one
// instruction, and popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), exact
// in int32.  Both operands stay as stored: "row.col" with K contiguous is
// the [N, 8] and [M, 8] rows as they lie.  So what is left is the output's
// bytes and the launch.
//
// Design: a warp computes a 16 x 32 tile (four 16 x 8 MMAs), kWarps warps
// side by side along M per block (a 16 x 128 block tile: 16 blocks of 4
// warps at 128 x 256, 384 at 256 x 3072).  The grid is one-dimensional,
// the column tiles of a row tile consecutive, so neither side is held to
// grid.y's 65535.  Lane (g, t) = (lane / 4, lane % 4)
// holds a's rows g and g + 8 and b's column g of each n8 block, two words
// each: words 2t and 2t + 1 of the row, one 8-byte load, so a warp's load
// covers 8 whole 32-byte rows.  The MMA's K order is permuted alike in a
// and b (its k-words t and t + 4 are our words 2t and 2t + 1), which a sum
// over all 256 bits does not see.  popc(a) and popc(b) per row: the lane's
// two words, summed over the 4 lanes of a group with two shuffles.  The
// accumulator fragment gives lane (g, t) the outputs (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1): one 8-byte store per row, so each store of
// the warp writes 8 whole 32-byte sectors (rows of 8 outputs).
//
// Measured on the H100 against the forms it was chosen from (PERF.md):
// warp tiles of 16 x 16 and 16 x 64, 1 and 2 warps per block, the same MMA
// on .xor.popc (which ptxas takes for sm_90a; no faster), and a CUDA-core
// form (a 4 x 4 micro-tile per lane from descriptors in registers, __popc)
// that is slower at every shape timed.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 16;       // the MMA's m
constexpr int kNB = 4;                  // n8 blocks per warp: a 16 x 32 warp tile
constexpr int kWarps = 4;               // warps per block, side by side along M
constexpr int kColsPerBlock = 8 * kNB * kWarps;

// c += popc(a & b) over K = 256 for the 16 x 8 tile: a's fragment (rows g,
// g + 8 at k-words t, then t + 4), b's (column g at k-words t, t + 4).
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sum over the 4 lanes of a group (lanes 4g .. 4g + 3).
__device__ __forceinline__ int group_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Every lane of a warp takes part in each MMA and shuffle, so a warp past
// M returns as a whole and the ragged edges load zeros.
__global__ void __launch_bounds__(32 * kWarps)
hamming_mma_kernel(const uint2* __restrict__ a, const uint2* __restrict__ b, int N, int M,
                   int* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col_tiles = (M + kColsPerBlock - 1) / kColsPerBlock;
  const int n0 = (blockIdx.x / col_tiles) * kRowsPerBlock;
  const int m0 = (blockIdx.x % col_tiles * kWarps + warp) * (8 * kNB);
  if (m0 >= M) return;
  const uint2 z = make_uint2(0u, 0u);
  const int r0 = n0 + g, r1 = n0 + g + 8;
  const uint2 x0 = r0 < N ? __ldg(a + (size_t)r0 * 4 + t) : z;
  const uint2 x1 = r1 < N ? __ldg(a + (size_t)r1 * 4 + t) : z;
  uint2 y[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int col = m0 + 8 * j + g;
    y[j] = col < M ? __ldg(b + (size_t)col * 4 + t) : z;
  }
  const uint32_t af[4] = {x0.x, x1.x, x0.y, x1.y};
  const int pa0 = group_sum(__popc(x0.x) + __popc(x0.y));
  const int pa1 = group_sum(__popc(x1.x) + __popc(x1.y));
  const bool vec = M % 2 == 0;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int pb = group_sum(__popc(y[j].x) + __popc(y[j].y));     // column 8j + g
    const int pb0 = __shfl_sync(0xffffffffu, pb, 8 * t);           // column 8j + 2t
    const int pb1 = __shfl_sync(0xffffffffu, pb, 8 * t + 4);       // column 8j + 2t + 1
    int c[4] = {0, 0, 0, 0};
    const uint32_t bf[2] = {y[j].x, y[j].y};
    mma_and_popc(c, af, bf);
    const int col = m0 + 8 * j + 2 * t;
    const int v[4] = {pa0 + pb0 - 2 * c[0], pa0 + pb1 - 2 * c[1],
                      pa1 + pb0 - 2 * c[2], pa1 + pb1 - 2 * c[3]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r >= N || col >= M) continue;
      int* dst = out + (size_t)r * M + col;
      if (vec) {
        *reinterpret_cast<int2*>(dst) = make_int2(v[2 * h], v[2 * h + 1]);
      } else {
        dst[0] = v[2 * h];
        if (col + 1 < M) dst[1] = v[2 * h + 1];
      }
    }
  }
}

}  // namespace

// a [N, 8] and b [M, 8] words, both 16-byte aligned -> out [N, M].
extern "C" int hamming_launch(const int* a, const int* b, int N, int M, int* out,
                              cudaStream_t stream) {
  if (N <= 0 || M <= 0) return 0;
  if ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((M + kColsPerBlock - 1) / kColsPerBlock) *
                           ((N + kRowsPerBlock - 1) / kRowsPerBlock);
  if (blocks > 0x7fffffffLL || N > 0x7fffffff - kRowsPerBlock) return (int)cudaErrorInvalidValue;
  hamming_mma_kernel<<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(reinterpret_cast<const uint2*>(a),
                                                       reinterpret_cast<const uint2*>(b), N, M,
                                                       out);
  return (int)cudaGetLastError();
}
