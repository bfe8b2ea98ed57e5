// SIMT building blocks of the port's register-tiled fp32 kernels, shared by
// the sources in this directory: 32-column blocks of a row-major (L, D)
// fp32 matrix copied by cp.async into shared memory, 4 x 4 outer-product
// tiles over them (the fp32 K1 in flash_fwd.cu, the fp32 K2 and K3 in
// flash_bwd.cu), and the 8-row product tiles of K2 and K3.

#pragma once

#include <stddef.h>

#include "sm90.cuh"

namespace simt {

// The register-tiled fp32 kernels: blocks of 256 threads stream 64-row,
// 32-column blocks of their (L, D) inputs (D a multiple of 32) through a
// ring of kF32Ring stages, one cp.async group a step started kF32Ahead
// steps ahead; each staged row is padded to 36 floats, so that the 16-byte
// loads of 8 consecutive rows fall in distinct banks.
constexpr int kF32Threads = 256;
constexpr int kF32Ahead = 2;  // steps a load is started ahead of its use
constexpr int kF32Ring = kF32Ahead + 1;  // stages of the block ring
constexpr int kF32Rows = 64;            // rows of a staged block
constexpr int kF32Block = 32;           // D columns of a staged block
constexpr int kF32Row = kF32Block + 4;  // floats of a staged row

// rows [r0, r0 + kF32Rows) and columns [col, col + kF32Block) of a
// row-major (L, ld) fp32 matrix into a staged block (rows of kF32Row
// floats); rows at or past L are zero and no byte of them is read
__device__ __forceinline__ void load_f32_block(float* dst, const float* src,
                                               int r0, int L, int ld,
                                               int col) {
  constexpr int kPerRow = kF32Block / 4;  // 16-byte chunks of a row
#pragma unroll
  for (int j = 0; j < kF32Rows * kPerRow / kF32Threads; ++j) {
    const int i = threadIdx.x + j * kF32Threads;
    const int r = i / kPerRow, c = i % kPerRow;
    const int g = r0 + r;
    sm90::cp_async_16(dst + r * kF32Row + 4 * c,
                      src + (size_t)(g < L ? g : 0) * ld + col + 4 * c,
                      g < L ? 16 : 0);
  }
}

// acc[i][j] += sum over a staged block's columns of a[kAStep i] .
// b[kBStep j] (a and b: a thread's first rows in two staged blocks): a
// 4 x 4 outer-product tile, 16 FMAs for every two 16-byte loads
template <int kAStep, int kBStep>
__device__ __forceinline__ void f32_tile_product(float (&acc)[4][4],
                                                 const float* a,
                                                 const float* b) {
#pragma unroll
  for (int d = 0; d < kF32Block; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + kAStep * i * kF32Row + d);
      y[i] = *reinterpret_cast<const float4*>(b + kBStep * i * kF32Row + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[r][c] += sum over the kF32Rows rows k of a[k][r] b[k][c]: the 8 x
// kCols product tile of a thread over two row-major blocks in shared memory
// (the fp32 K2's dQ += dS K, the fp32 K3's dV += P^T dO and dK += dS^T Q).
// a points at the thread's 8 values in row 0 (rows of a_ld floats), b at
// its first column in row 0 (rows of b_ld floats); the thread's columns
// are 0..3 and, for kCols = 8, 32..35, so that one 16-byte load of a warp
// reads 8 neighbouring pieces of one row. Per row two 16-byte loads of a
// and kCols / 4 of b feed 8 kCols FMAs.
template <int kCols>
__device__ __forceinline__ void f32_rows_product(float (&acc)[8][kCols],
                                                 const float* a, int a_ld,
                                                 const float* b, int b_ld) {
  static_assert(kCols == 4 || kCols == 8, "4 or 8 columns a thread");
#pragma unroll 4
  for (int k = 0; k < kF32Rows; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * a_ld);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * a_ld + 4);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float br[kCols];
#pragma unroll
    for (int h = 0; h < kCols / 4; ++h) {
      const float4 x =
          *reinterpret_cast<const float4*>(b + k * b_ld + 32 * h);
      br[4 * h] = x.x;
      br[4 * h + 1] = x.y;
      br[4 * h + 2] = x.z;
      br[4 * h + 3] = x.w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

}  // namespace simt
