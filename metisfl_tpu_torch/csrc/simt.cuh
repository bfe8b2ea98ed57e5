// SIMT building block of the port's fp32 general head-dim kernels (any D),
// shared by the sources in this directory: the staging of a chunk of 64
// columns of a row-major (L, D) fp32 matrix into a tile in shared memory.

#pragma once

#include <stddef.h>

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

}  // namespace simt
