// Tensor-core and asynchronous-copy building blocks for the port's kernels
// (sm_90a), shared by the sources in this directory.
//
// - cp.async: 16 bytes (or 4) per thread from device memory into shared
//   memory, with a source size that zero-fills what lies past the tensor.
// - Tiles in shared memory: a tile of ROWS rows and D 16-bit columns is
//   stored as column blocks of ROWS rows each, W = block_bytes<D>() bytes a
//   row: 128 bytes (64 values) for D >= 64, else the whole row (32 bytes at
//   D = 16, 64 at D = 32). 16-byte chunk c of row r of a block sits at
//   chunk c ^ s(r) of its row, where s(r) XORs address bits 7.. into bits
//   4..: the 128-, 64- and 32-byte swizzles of wgmma's (and TMA's)
//   SWIZZLE_128B/64B/32B modes (CUTLASS's Swizzle<3,4,3>, <2,4,3>,
//   <1,4,3>), with every column block aligned to its 8-row pattern (1024,
//   512 or 256 bytes). A block can also be loaded on its own from a matrix
//   whose row stride is known only at run time (load_block_async), for the
//   general head-dim kernels, and a tile from rows narrower than the tile
//   (load_tile_async's ld: the columns past ld are zero-filled, never read).
// - wgmma.mma_async m64nNk16 with fp32 accumulation, for bf16 and fp16
//   operands, from one warpgroup (4 warps). B comes from shared memory
//   through a matrix descriptor, read K-major (a tile stored [n][k]) or
//   MN-major (stored [k][n], the transposed reading); A from shared memory
//   or from registers. The accumulator of warp w holds rows 16 w + g and
//   16 w + g + 8 (g = lane / 4) at columns 8 j + 2 t, +1 (t = lane % 4) in
//   d[4 j .. 4 j + 3], the layout of mma.m16n8: two neighbouring 8-column
//   chunks, rounded to pairs, are the A operand of a 16-deep k step, the
//   FlashAttention-2 reuse of P and dS straight from registers.
//
// Descriptor strides (checked on the card at all three widths): K-major
// takes the stride between 8-row groups (8 W bytes) as SBO and steps along
// k inside the W-byte row by 32 bytes a k16 step; MN-major takes the
// stride between 8-row k groups (8 W bytes) as SBO, and LBO steps between
// column blocks along N (unused where N is one block's width, as in every
// call here).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, asynchronously; only the first
// src_bytes are read and the rest of the 16 are zero (0: src is not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, as cp_async_16
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// columns of one column block of a tile D 16-bit values wide, and the bytes
// of its rows (its swizzle: 128, 64 or 32)
template <int D>
__host__ __device__ constexpr int block_cols() {
  static_assert(D == 16 || D == 32 || D % 64 == 0, "a tile width wgmma reads");
  return D < 64 ? D : 64;
}

template <int D>
__host__ __device__ constexpr int block_bytes() {
  return 2 * block_cols<D>();
}

// the SWIZZLE mode of rows of W bytes, as a descriptor's bits 62-63 give it
template <int W>
__host__ __device__ constexpr uint64_t swizzle_mode() {
  static_assert(W == 32 || W == 64 || W == 128, "a wgmma swizzle");
  return W == 128 ? 1 : W == 64 ? 2 : 3;
}

// byte offset of 16-byte chunk `chunk` (8 columns) of row `row` in a
// swizzled tile of ROWS rows whose column blocks have W-byte rows
template <int ROWS, int W = 128>
__device__ __forceinline__ uint32_t tile_chunk_bytes(int row, int chunk) {
  constexpr int kChunks = W / 16;  // chunks of a block's row
  const uint32_t o = (uint32_t)(row * W + (chunk % kChunks) * 16);
  return (uint32_t)((chunk / kChunks) * ROWS * W) +
         (o ^ ((o >> 3) & ((kChunks - 1) << 4)));
}

// rows [r0, r0 + ROWS) of a row-major (L, ld) matrix into a swizzled tile D
// columns wide, one 16-byte cp.async per chunk; ld <= D is a multiple of 8
// (16-byte rows). Rows at or past L and columns at or past ld are zero and
// no byte of them is read.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* tile, const T* src, int r0,
                                                int L, int ld = D) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const int g = r0 + r;
    const bool in = g < L && c * 8 < ld;
    const T* from = src + (size_t)(g < L ? g : 0) * ld + (in ? c * 8 : 0);
    cp_async_16(reinterpret_cast<char*>(tile) +
                    tile_chunk_bytes<ROWS, block_bytes<D>()>(r, c),
                from, in ? 16 : 0);
  }
}

// rows [r0, r0 + ROWS) and columns [c0, c0 + 64) of a row-major (L, ld)
// matrix whose row stride ld is known only at run time, into one swizzled
// 64-column block of ROWS rows: the layout load_tile_async gives each of
// its column blocks, so desc_k_major and desc_mn_major read it unchanged.
// ld and c0 are multiples of 8 (16-byte rows); rows at or past L are zero
// and no byte of them is read.
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void load_block_async(T* block, const T* src,
                                                 int r0, int L, int ld,
                                                 int c0) {
  static_assert(ROWS * 8 % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i >> 3, c = i & 7;
    const int g = r0 + r;
    const T* from = src + (size_t)(g < L ? g : 0) * ld + c0 + c * 8;
    cp_async_16(reinterpret_cast<char*>(block) + tile_chunk_bytes<ROWS>(r, c),
                from, g < L ? 16 : 0);
  }
}

// cp.async writes are not seen by wgmma (the async proxy) until the
// writing thread fences, before the barrier that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads') over `threads` threads,
// a multiple of 32: arrive signals without waiting, sync waits until all
// have arrived; shared-memory writes before an arrive are seen by the
// threads that sync (the producer / consumer hand-off between warpgroups)
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// named_barrier_arrive where `when` holds (the same across each warp), as
// one predicated instruction: no branch splits the code around it (ptxas
// serializes the wgmma of a kernel whose in-flight products span a branch)
__device__ __forceinline__ void named_barrier_arrive_if(bool when, int id,
                                                        int threads) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p bar.arrive %1, %2;\n}\n"
      ::"r"((int)when), "r"(id), "r"(threads)
      : "memory");
}

// orders register writes before the wgmma that read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// after wgmma_wait: the accumulators are read no earlier than here
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int W = 128>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle_mode<W>() << 62);
}

// a tile of ROWS rows (column blocks of W-byte rows) read K-major (rows are
// M or N, columns are k) at the k16 step kk
template <int ROWS, int W = 128>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  constexpr int kSteps = W / 32;  // k16 steps in a block's row
  return descriptor<W>(tile + (kk / kSteps) * ROWS * W + (kk % kSteps) * 32,
                       16, 8 * W);
}

// a tile of ROWS rows (column blocks of W-byte rows) read MN-major (rows are
// k, columns are N): the k16 step from row row0, the W / 2 columns of
// column block `block`
template <int ROWS, int W = 128>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int row0,
                                                  int block) {
  return descriptor<W>(tile + block * ROWS * W + row0 * W, ROWS * W, 8 * W);
}

// d (64 x N) = or += A (64 x 16, K-major descriptor) * B (16 x N, K-major
// descriptor)
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

// d (64 x N, R = N / 2 accumulators a thread; N = 16, 32 or 64) += A (64 x
// 16, registers) * B (16 x N, MN-major descriptor)
template <typename T, int R>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[R],
                                            const uint32_t (&a)[4],
                                            uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(
    float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 64>(
    float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 32>(
    float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 32>(
    float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = or += A (64 x 16, registers) * B (16 x 64, K-major
// descriptor)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__nv_bfloat16, 32>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__half, 32>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__nv_bfloat16, 16>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__half, 16>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__nv_bfloat16, 8>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<__half, 8>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (lo, hi) rounded to nearest into one register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand of one k16 step from the accumulators of its two 8-column
// chunks (c[0..3] columns 0-7, c[4..7] columns 8-15), rounded to T
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack2<T>(c[0], c[1]);
  a[1] = pack2<T>(c[2], c[3]);
  a[2] = pack2<T>(c[4], c[5]);
  a[3] = pack2<T>(c[6], c[7]);
}

// the A operand of k16 step kk (columns 16 kk..) for this thread's rows
// r and r + 8 of a 64-row tile stored as load_tile_async stores it (t =
// lane % 4), read from shared memory: the registers acc_to_a would make
// from those rows' values
template <int ROWS>
__device__ __forceinline__ void tile_to_a(uint32_t (&a)[4], const void* tile,
                                          int r, int t, int kk) {
  const char* base = static_cast<const char*>(tile);
  a[0] = *reinterpret_cast<const uint32_t*>(
      base + tile_chunk_bytes<ROWS>(r, 2 * kk) + 4 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(
      base + tile_chunk_bytes<ROWS>(r + 8, 2 * kk) + 4 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(
      base + tile_chunk_bytes<ROWS>(r, 2 * kk + 1) + 4 * t);
  a[3] = *reinterpret_cast<const uint32_t*>(
      base + tile_chunk_bytes<ROWS>(r + 8, 2 * kk + 1) + 4 * t);
}

}  // namespace sm90
