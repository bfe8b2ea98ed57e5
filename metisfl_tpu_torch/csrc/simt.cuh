// SIMT building blocks of the port's general head-dim kernels (any D, any
// dtype), shared by the sources in this directory: conversions between the
// input dtypes and fp32, and the staging of a chunk of 64 columns of a
// row-major (L, D) matrix into an fp32 tile in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>

namespace simt {

constexpr int kChunk = 64;  // D columns staged at a time, and per output

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernels' casts of P and dS
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// rows [r0, r0 + ROWS) and columns [c0, c0 + kChunk) of a row-major (L, D)
// matrix into an fp32 tile with rows padded to kChunk + 1 floats (the lanes
// of a row and the rows of a warp then fall in distinct banks); what lies
// past L or D is zero. Neighbouring threads read neighbouring columns.
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int r0,
                                           int L, int c0, int D) {
  for (int i = threadIdx.x; i < ROWS * kChunk; i += THREADS) {
    const int r = i / kChunk, d = i % kChunk;
    const int g = r0 + r, col = c0 + d;
    dst[r * (kChunk + 1) + d] =
        g < L && col < D ? to_f<T>(src[(size_t)g * D + col]) : 0.f;
  }
}

}  // namespace simt
