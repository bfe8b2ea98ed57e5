// SIMT building blocks of the port's fp32 kernels beyond the builds (any D),
// shared by the sources in this directory: the staging of a chunk of 64
// columns of a row-major (L, D) fp32 matrix into a tile in shared memory
// (the general K2), and the register-tiled kernels' 32-column blocks,
// copied by cp.async, and their 4 x 4 outer-product tiles (the fp32 K1 in
// flash_fwd.cu, the fp32 K3 in flash_bwd.cu).

#pragma once

#include <stddef.h>

#include "sm90.cuh"

namespace simt {

constexpr int kChunk = 64;  // D columns staged at a time, and per output

// rows [r0, r0 + ROWS) and columns [c0, c0 + kChunk) of a row-major (L, D)
// matrix into a tile with rows padded to kChunk + 1 floats (the lanes of a
// row and the rows of a warp then fall in distinct banks); what lies past L
// or D is zero. Neighbouring threads read neighbouring columns.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int r0, int L, int c0, int D) {
  for (int i = threadIdx.x; i < ROWS * kChunk; i += THREADS) {
    const int r = i / kChunk, d = i % kChunk;
    const int g = r0 + r, col = c0 + d;
    dst[r * (kChunk + 1) + d] =
        g < L && col < D ? src[(size_t)g * D + col] : 0.f;
  }
}

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

}  // namespace simt
