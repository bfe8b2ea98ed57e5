// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (metisfl_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel metisfl_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward through pl.pallas_call). It computes what that
// kernel computes: O = softmax(Q K^T / sqrt(D)) V with an online softmax, an
// unnormalised fp32 accumulator divided once at the store (FlashAttention-2),
// the fp32 logsumexp per query row, and O = 0 for a row with no unmasked key.
// P is rounded to the input dtype before the P.V product, as the TPU kernel
// casts p to v.dtype, and the row sum l adds the unrounded fp32 P.
//   - GQA: query head h reads kv head h / (Hq/Hkv); K and V are never
//     repeated in memory.
//   - Causal (q_pos >= k_pos): the loop stops at the last K tile that
//     overlaps the q tile, which skips about half the work.
//   - Ragged L: keys with k_pos >= L are masked and rows >= L are neither
//     read nor stored; no padded copy is made.
//   - lse is written in logical layout (B, Hq, L) fp32.
//
// Bound at the serving shape (B=4, Hq=16, Hkv=4, L=1024, D=64, bf16,
// causal; 524,800 (q, k) pairs per head, 64 heads): Q K^T and P V are 4 D
// operations per pair, 8.6 GFLOP, 8.7 us at 989 TFLOP/s; about 21 MB moved
// is 6.3 us at 3.35 TB/s. So it is bound by the tensor cores' rate, and
// both products have to run on them.
//
// bf16 and fp16: a tensor-core kernel (flash_fwd_mma_kernel) on the
// building blocks of sm90.cuh; its loop is the dQ kernel's (flash_bwd.cu).
//   - One warpgroup (4 warps) per 64-row q tile of one (batch, query head);
//     warp w owns rows 16 w..16 w + 15. A loop over the K/V tiles takes the
//     place of the TPU kernel's sequential grid axis and its VMEM scratch.
//   - Q is loaded once; K and V stream through a two-stage cp.async ring
//     (16 bytes per thread, zero-filled past L), all in 128-byte-swizzled
//     tiles; every copy is fenced into the async proxy before the barrier
//     that publishes it to wgmma.
//   - S = Q K^T is wgmma.mma_async m64n64k16 with fp32 accumulation, Q and
//     K read K-major from shared memory through matrix descriptors.
//   - The online softmax runs on the accumulator fragment in registers:
//     each thread holds parts of two rows, whose max reduces over the
//     row's 4 lanes by shuffles. m, l and alpha stay fp32, in base 2
//     (exp2 of scale * log2(e) * s). Masks are applied only on tiles that
//     cross the diagonal or the end of the sequence. Each thread keeps its
//     own part of l, reduced over the row's lanes once, at the store.
//   - O += P V: P rounded to the input dtype in registers is the A operand
//     (that conversion is the TPU kernel's cast), V is read MN-major (the
//     reduction runs over keys), one wgmma per k16 step of keys and
//     64-column block of D (one n = D block below 64). O stays in fp32
//     registers (8 per thread at D = 16, 16 at 32, 32 at 64, 64 at 128,
//     128 at 256) until one store.
//   - Head dims 16, 32, 64 and 128 on this kernel, the tile shapes
//     unchanged (64-row q and K/V tiles): shared memory holds Q and two K/V
//     stages in 10, 20, 40 and 80 KB. At D = 16 and 32
//     a tile's row is one column block of 32 or 64 bytes in wgmma's 32- and
//     64-byte swizzles, S takes D / 16 k-steps (one at D = 16) and P V an
//     n = D product, so no step runs on zero columns; the small blocks
//     leave room for many on an SM. A build reads the caller's rows at
//     their own length ld (a multiple of 8 up to D): cp.async zero-fills
//     columns ld.. in shared memory and only ld columns of O are stored.
//     The wrapper passes ld < D to the D = 16 and 32 builds, so D = 8 and
//     24 need no padded copy; it pads any other D up to 256 to the next
//     build (ld = D there); a D above 256 goes to the
//     general tensor-core kernel (flash_fwd_general_mma_kernel, below),
//     whose Q and K stream through shared memory 64 columns at a time, so
//     that no D is too large.
//   - D = 256 (flash_fwd_mma_256_kernel): O is 128 fp32 a thread, so one
//     warpgroup of this kernel filled an SM's registers (255, spilling)
//     and its 160 KB of shared memory, and ran alone on the SM: nothing
//     covered its softmax, and each K/V tile was read from L2 for 64 query
//     rows. The D = 256 build is a block of two warpgroups over a 128-row q
//     tile: warpgroup w owns rows 64 w..64 w + 63 with its own O, m and l,
//     both read one K/V stage (every tile read once for 128 rows; 192 KB:
//     Q 64 KB and two stages, one block an SM), and they take turns to
//     issue S = Q K^T through two named barriers, so that one's softmax
//     runs while the other's products do (FlashAttention-3's ping-pong,
//     without its producer warp). Each row's sequence of products, masks
//     and softmax steps is the 64-row kernel's, so O and lse keep its
//     bits. Warpgroup 1's rows need one K tile more on a causal diagonal
//     (warpgroup 0 skips it), and a warpgroup whose rows lie past L stores
//     nothing; both stay in every barrier. Where 128-row tiles would leave
//     SMs idle that 64-row ones fill (B2 Hq4 L256; causal grids up to about
//     one longest walk of work per SM), the caller asks for 64-row tiles,
//     warpgroup 1 idle: twice the blocks, each the one-warpgroup kernel's
//     walk (fwd_rows in ops/flash_attention.py, from timings of both).
//     Issue, turn and wait of each product group are one branch-free
//     stretch of code, and O's rescale is fenced before the P V products:
//     ptxas otherwise serializes every wgmma of the kernel (PERF.md). 225
//     registers, no spill.
//   - Causal work is uneven (the last q tile walks every K tile), so the
//     1-D grid hands out the longest tiles first. No atomics: the same bits
//     on every run.
//   - Not yet: TMA loads and a producer warp (the K/V loads cost ~17% of
//     the D = 256 build, PERF.md), keeping the next tile's Q K^T in flight
//     across this tile's softmax (32 more registers a thread), and staging
//     O through shared memory for 16-byte stores.
//
// fp32: one register-tiled SIMT kernel for every D (flash_fwd_f32_kernel,
// below), a deliberate choice by dtype: TF32 tensor cores keep 10 bits of
// mantissa, which the fp32 tolerance and the JAX package's fp32 numerics do
// not allow. Its tiles, ring and slabs are the fp32 K3's (flash_bwd.cu),
// over the building blocks of simt.cuh.

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;     // rows of a q tile and of a K/V tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core kernel

constexpr int kMmaThreads = 128;  // one warpgroup; a warp owns 16 tile rows

// One K tile's step of the online softmax on the S fragment of a 64-row q
// tile: this thread's parts of rows row_a and row_b against keys k0..k0 +
// 63, in wgmma's accumulator layout (sm90.cuh). The scores are scaled into
// base 2 and masked on tiles that cross the diagonal or the end of the
// sequence; the tile's row max reduces over the row's 4 lanes. s becomes
// P = exp2(x - m), 0 where masked; m and this thread's part of l (the
// unrounded P) advance; alpha_a and alpha_b are the factors that rescale O.
__device__ __forceinline__ void softmax_step(float (&s)[32], int q0, int k0,
                                             int row_a, int row_b, int t,
                                             int L, int causal,
                                             float scale_log2, float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& alpha_a,
                                             float& alpha_b) {
  const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > L;
  float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = i & 2;
    float x = s[i] * scale_log2;
    if (edge) {
      const int k_pos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (k_pos >= L || (causal && k_pos > (hi ? row_b : row_a))) x = kNeg;
    }
    s[i] = x;
    if (hi)
      mx_b = fmaxf(mx_b, x);
    else
      mx_a = fmaxf(mx_a, x);
  }
#pragma unroll
  for (int lanes = 1; lanes <= 2; lanes <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, lanes));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, lanes));
  }
  const float next_a = fmaxf(m_a, mx_a), next_b = fmaxf(m_b, mx_b);
  alpha_a = exp2f(m_a - next_a);
  alpha_b = exp2f(m_b - next_b);
  m_a = next_a;
  m_b = next_b;

  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = i & 2;
    float p = exp2f(s[i] - (hi ? m_b : m_a));
    if (edge && s[i] <= kNeg) p = 0.f;
    s[i] = p;
    if (hi)
      sum_b += p;
    else
      sum_a += p;
  }
  l_a = alpha_a * l_a + sum_a;
  l_b = alpha_b * l_b + sum_b;
}

// after the last K tile: l summed over the row's 4 lanes, and 1 / l (0 for a
// row with no unmasked key, l == 0, which stores 0, not nan)
__device__ __forceinline__ void finish_rows(float& l_a, float& l_b,
                                            float& inv_a, float& inv_b) {
#pragma unroll
  for (int lanes = 1; lanes <= 2; lanes <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, lanes);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, lanes);
  }
  inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
  inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
}

// lse = m ln 2 + log l of rows row_a and row_b, from one lane of the four;
// m ln 2 rounded before the sum (never fused into one FMA, which ptxas
// would do in some kernels and not in others), so every build gives the
// same bits
__device__ __forceinline__ void store_lse(float* lse_bh, int row_a, int row_b,
                                          int L, int t, float m_a, float m_b,
                                          float l_a, float l_b) {
  if (t != 0) return;
  if (row_a < L)
    lse_bh[row_a] = __fmul_rn(m_a, kLn2) + logf(fmaxf(l_a, 1e-30f));
  if (row_b < L)
    lse_bh[row_b] = __fmul_rn(m_b, kLn2) + logf(fmaxf(l_b, 1e-30f));
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // the resident Q tile, two stages of K and V tiles (16-bit values)
  return 2 * (size_t)(kTile * D + 2 * 2 * kTile * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int L, int ld,
                     float scale, int causal) {
  // O's columns a P V wgmma makes (its N), and the bytes of a tile's rows
  // in one column block (their swizzle)
  constexpr int kN = sm90::block_cols<D>(), kW = sm90::block_bytes<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // kTile x D, swizzled
  T* sK = sQ + kTile * D;                  // 2 stages x kTile x D
  T* sV = sK + 2 * kTile * D;              // 2 stages x kTile x D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + kTile - 1) / kTile;
  const int heads = gridDim.x / nq;  // B * Hq
  const int bh = blockIdx.x % heads;
  const int rank = blockIdx.x / heads;
  // causal: the last q tile walks every K tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  // the caller's rows are ld <= D values (columns ld.. load as zeros)
  const T* kb = k + (size_t)kvh * L * ld;
  const T* vb = v + (size_t)kvh * L * ld;

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sQ, q + (size_t)bh * L * ld, q0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sK, kb, 0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sV, vb, 0, L, ld);
  sm90::cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_smem = sm90::smem_addr(sQ);

  float acc_o[D / kN][kN / 2], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc_o[c][i] = 0.f;
  // running max (base 2) and this thread's part of the running sum
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int n_k = (k_end + kTile - 1) / kTile;
  for (int it = 0; it < n_k; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_k) {
      const int next = (it + 1) * kTile;
      sm90::load_tile_async<T, D, kTile, kMmaThreads>(
          sK + (stage ^ 1) * kTile * D, kb, next, L, ld);
      sm90::load_tile_async<T, D, kTile, kMmaThreads>(
          sV + (stage ^ 1) * kTile * D, vb, next, L, ld);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this stage (and Q) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int k0 = it * kTile;
    const uint32_t k_smem = sm90::smem_addr(sK + stage * kTile * D);
    const uint32_t v_smem = sm90::smem_addr(sV + stage * kTile * D);

    // S = Q K^T, 64 rows x 64 keys in D / 16 k-steps, K read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile, kW>(q_smem, kk),
                               sm90::desc_k_major<kTile, kW>(k_smem, kk),
                               kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    float alpha_a, alpha_b;
    softmax_step(s, q0, k0, row_a, row_b, t, L, causal, scale_log2, m_a, m_b,
                 l_a, l_b, alpha_a, alpha_b);
#pragma unroll
    for (int c = 0; c < D / kN; ++c)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        acc_o[c][i] *= (i & 2) ? alpha_b : alpha_a;

    // O += P V, P rounded to the input dtype from registers; V read
    // MN-major ([key][d], the reduction runs over keys), one n = kN wgmma
    // per k16 step of keys and column block
    uint32_t ap[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ap[kk], s + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / kN; ++c)
        sm90::wgmma_rs_mn<T>(
            acc_o[c], ap[kk],
            sm90::desc_mn_major<kTile, kW>(v_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kN; ++c) sm90::fence_operands(acc_o[c]);
    __syncthreads();  // done with this stage before it is refilled
  }

  float inv_a, inv_b;
  finish_rows(l_a, l_b, inv_a, inv_b);
  // only the caller's ld columns are stored, at its row stride
  T* out = o + (size_t)bh * L * ld;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kN * c + 8 * j + 2 * t;
      if (col >= ld) continue;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * ld + col) =
            sm90::pack2<T>(acc_o[c][4 * j] * inv_a,
                           acc_o[c][4 * j + 1] * inv_a);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * ld + col) =
            sm90::pack2<T>(acc_o[c][4 * j + 2] * inv_b,
                           acc_o[c][4 * j + 3] * inv_b);
    }
  store_lse(lse + (size_t)bh * L, row_a, row_b, L, t, m_a, m_b, l_a, l_b);
}

// K1 at D = 256: two warpgroups over a 128-row q tile (see the note at the
// top); its softmax, row sums and stores are the 64-row kernel's
constexpr int kMma256Threads = 2 * kMmaThreads;
constexpr int kMma256Rows = 2 * kTile;  // q rows of a block
// named barriers 2 and 3: warpgroup w waits on 2 + w for its turn to issue
// S = Q K^T (0 is __syncthreads')
constexpr int kTurnBarrier = 2;

constexpr size_t mma_256_smem_bytes() {
  // the resident 128-row Q tile, two stages of K and V tiles (16-bit values)
  return 2 * (size_t)(kMma256Rows * 256 + 2 * 2 * kTile * 256);
}
static_assert(mma_256_smem_bytes() <= 232448, "fits an SM's 227 KB");

// rows: the q rows of a block, kMma256Rows, or kTile (warpgroup 1 then has
// no rows), the caller's choice (fwd_rows in ops/flash_attention.py)
template <typename T>
__global__ void __launch_bounds__(kMma256Threads, 1)
flash_fwd_mma_256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int Hq, int Hkv, int L,
                         int ld, float scale, int causal, int rows) {
  constexpr int D = 256, kN = sm90::block_cols<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // two kTile x D tiles, swizzled: warpgroup w's rows at w kTile D
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kMma256Rows * D;  // 2 stages x kTile x D
  T* sV = sK + 2 * kTile * D;    // 2 stages x kTile x D

  // the warpgroup, known to the compiler as the same across each warp
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kMmaThreads, 0);
  const int tid = threadIdx.x % kMmaThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + rows - 1) / rows;
  const int heads = gridDim.x / nq;  // B * Hq
  const int bh = blockIdx.x % heads;
  const int rank = blockIdx.x / heads;
  // causal: the last q tile walks every K tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * rows;
  const int qw = q0 + wg * kTile;  // this warpgroup's first row
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const T* qb = q + (size_t)bh * L * ld;
  const T* kb = k + (size_t)kvh * L * ld;
  const T* vb = v + (size_t)kvh * L * ld;

  // the block's rows of Q (past them, or past L, zeros that read nothing)
  const int q_end = min(L, q0 + rows);
  sm90::load_tile_async<T, D, kTile, kMma256Threads>(sQ, qb, q0, q_end, ld);
  sm90::load_tile_async<T, D, kTile, kMma256Threads>(sQ + kTile * D, qb,
                                                     q0 + kTile, q_end, ld);
  sm90::load_tile_async<T, D, kTile, kMma256Threads>(sK, kb, 0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMma256Threads>(sV, vb, 0, L, ld);
  sm90::cp_async_commit();

  // the K tiles this warpgroup's rows need (causal: up to their diagonal;
  // none where it has no rows, or they lie wholly past L), and the
  // block's: its last warpgroup's
  const int n_own =
      qw >= q_end ? 0
                  : ((causal ? min(L, qw + kTile) : L) + kTile - 1) / kTile;
  const int n_k = ((causal ? q_end : L) + kTile - 1) / kTile;

  // this thread's two rows of its warp's 16: g and g + 8
  const int row_a = qw + warp * 16 + g, row_b = row_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_smem = sm90::smem_addr(sQ + wg * kTile * D);

  float acc_o[D / kN][kN / 2], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc_o[c][i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  // warpgroup 0 issues the first S
  if (wg == 1) sm90::named_barrier_arrive(kTurnBarrier, kMma256Threads);
  for (int it = 0; it < n_k; ++it) {
    const int stage = it & 1;
    sm90::cp_async_wait<0>();  // this stage (and Q) have landed
    sm90::fence_proxy_async();
    __syncthreads();  // for every thread; both are done with the last stage
    if (it + 1 < n_k) {
      const int next = (it + 1) * kTile;
      sm90::load_tile_async<T, D, kTile, kMma256Threads>(
          sK + (stage ^ 1) * kTile * D, kb, next, L, ld);
      sm90::load_tile_async<T, D, kTile, kMma256Threads>(
          sV + (stage ^ 1) * kTile * D, vb, next, L, ld);
    }
    sm90::cp_async_commit();

    const int k0 = it * kTile;
    const bool active = it < n_own;
    const uint32_t k_smem = sm90::smem_addr(sK + stage * kTile * D);
    const uint32_t v_smem = sm90::smem_addr(sV + stage * kTile * D);

    // S = Q K^T in turns: warpgroup 1's products queue behind warpgroup
    // 0's, so that each one's softmax runs while the other's products do.
    // After its S is issued a warpgroup gives the other its turn (warpgroup
    // 0 takes none after the last tile); issue, turn and wait stay in one
    // branch-free stretch of code
    sm90::named_barrier_sync(kTurnBarrier + wg, kMma256Threads);
    const bool pass = wg == 0 || it + 1 < n_k;
    if (!active) {  // warpgroup 0 past its diagonal, or rows past L
      sm90::named_barrier_arrive_if(pass, kTurnBarrier + (wg ^ 1),
                                    kMma256Threads);
      continue;
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile>(q_smem, kk),
                               sm90::desc_k_major<kTile>(k_smem, kk),
                               kk > 0);
    sm90::wgmma_commit();
    sm90::named_barrier_arrive_if(pass, kTurnBarrier + (wg ^ 1),
                                  kMma256Threads);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    float alpha_a, alpha_b;
    softmax_step(s, qw, k0, row_a, row_b, t, L, causal, scale_log2, m_a, m_b,
                 l_a, l_b, alpha_a, alpha_b);
#pragma unroll
    for (int c = 0; c < D / kN; ++c)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        acc_o[c][i] *= (i & 2) ? alpha_b : alpha_a;

    // O += P V, P rounded to the input dtype from registers, V read
    // MN-major. O's rescaling is fenced in before the products start, so
    // that no instruction writes an accumulator while they run
    uint32_t ap[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ap[kk], s + 8 * kk);
#pragma unroll
    for (int c = 0; c < D / kN; ++c) sm90::fence_operands(acc_o[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / kN; ++c)
        sm90::wgmma_rs_mn<T>(acc_o[c], ap[kk],
                             sm90::desc_mn_major<kTile>(v_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kN; ++c) sm90::fence_operands(acc_o[c]);
  }

  if (n_own == 0) return;  // no rows of this block, or none before L
  float inv_a, inv_b;
  finish_rows(l_a, l_b, inv_a, inv_b);
  T* out = o + (size_t)bh * L * ld;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kN * c + 8 * j + 2 * t;
      if (col >= ld) continue;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * ld + col) =
            sm90::pack2<T>(acc_o[c][4 * j] * inv_a,
                           acc_o[c][4 * j + 1] * inv_a);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * ld + col) =
            sm90::pack2<T>(acc_o[c][4 * j + 2] * inv_b,
                           acc_o[c][4 * j + 3] * inv_b);
    }
  store_lse(lse + (size_t)bh * L, row_a, row_b, L, t, m_a, m_b, l_a, l_b);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 beyond the builds: tensor-core kernel
// (flash_fwd_general_mma_kernel), for any D that is a multiple of 64 (the
// wrapper zero-pads to one, as it pads to the builds)
//
// The D = 256 build holds Q resident and O's 256 columns in 128 fp32
// registers a thread (two warpgroups, 128 q rows). At D = 512, Q (64 KB),
// two K stages (128 KB) and two V stages (128 KB) would not fit the 227 KB
// of shared memory a block may use, and O would need 256 registers a
// thread. So:
//   - The grid gets an axis over 256-column chunks of O (kMmaChunk, the D =
//     256 build's accumulator): one block of one warpgroup per (64-row q
//     tile, chunk, b * Hq + h), tile-major with the longest causal tiles
//     first.
//   - S = Q K^T reduces over the full D on wgmma (m64n64k16, both read
//     K-major), one 64-column block of Q and of K at a time, streamed
//     through a ring of kRing stages by cp.async with the runtime row
//     stride D (sm90.cuh load_block_async). Every K tile is nb = D / 64
//     such steps and one more, which runs the online softmax (the tuned
//     kernel's softmax_step) and accumulates only this block's chunk,
//     O[:, c0:c0 + 256] += P V[:, c0:c0 + 256], P from registers and V's
//     chunk read MN-major. One cp.async group per step, started kAhead
//     steps ahead: a step's loads overlap the steps before it, and no D is
//     too large (80 KB of shared memory at any D).
//   - Every chunk of one q tile computes S, m and l by the same wgmma
//     sequence over the same blocks and the same masks, bit for bit, so the
//     chunks agree without a second pass; the first chunk writes the lse.
//     The last chunk is narrower where D is not a multiple of 256: its
//     products and stores skip the blocks past D.
//   - Work: S once per chunk, P V once, 2 D ceil(D / 256) + 2 D operations
//     a (q, k) pair: 6 D at D = 512 against the ideal 4 D (the SIMT kernel
//     it replaces computed S D / 64 times). Bound at B2 Hq16 Hkv4 L1024
//     D512 causal: 4 D a pair is 34.4 GFLOP, 0.0348 ms at 989 TFLOP/s; its
//     ~84 MB take 0.025 ms at 3.35 TB/s, so the tensor cores bound it.
//   - Each step waits for its products before the next, as in the tuned
//     kernels; no TMA, no warp specialisation yet.

constexpr int kMmaChunk = 256;  // O columns a block accumulates
constexpr int kBlock = 64;      // columns of a streamed block
constexpr int kAhead = 2;       // steps a load is started ahead of its use
constexpr int kRing = kAhead + 1;  // stages of the Q/K block ring

constexpr size_t general_mma_smem_bytes() {
  // kRing stages of a Q and a K block, and V's chunk (16-bit values)
  return 2 * (size_t)(kRing * 2 * kTile * kBlock + kTile * kMmaChunk);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_general_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ lse, int Hq, int Hkv, int L,
                             int D, float scale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // kRing stages, each a Q block then a K block (kTile x 64, swizzled)
  T* sQK = reinterpret_cast<T*>(smem_raw);
  T* sV = sQK + kRing * 2 * kTile * kBlock;  // V's chunk, kTile x kMmaChunk

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + kTile - 1) / kTile;
  const int nb = D / kBlock;  // the blocks S reduces over
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / (nq * chunks);  // B * Hq
  const int bh = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads % chunks;
  const int rank = blockIdx.x / (heads * chunks);
  // causal: the last q tile walks every K tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  const int c0 = chunk * kMmaChunk;
  const int nc = min(kMmaChunk, D - c0) / kBlock;  // this chunk's blocks
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const T* qb = q + (size_t)bh * L * D;
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;

  // per K tile, nb steps accumulate S and one runs the softmax and P V
  const int per = nb + 1;
  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int n_steps = (k_end + kTile - 1) / kTile * per;

  // one step's loads as one cp.async group (empty past the last step). A
  // Q/K stage is refilled kRing QK steps after its last use; V's chunk
  // is refilled at least one step after the P V that read it (nb >= kAhead)
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      if (blk < nb) {
        T* stage = sQK + (it * nb + blk) % kRing * 2 * kTile * kBlock;
        sm90::load_block_async<T, kTile, kMmaThreads>(stage, qb, q0, L, D,
                                                      kBlock * blk);
        sm90::load_block_async<T, kTile, kMmaThreads>(
            stage + kTile * kBlock, kb, it * kTile, L, D, kBlock * blk);
      } else {
        for (int c = 0; c < nc; ++c)
          sm90::load_block_async<T, kTile, kMmaThreads>(
              sV + c * kTile * kBlock, vb, it * kTile, L, D, c0 + kBlock * c);
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kAhead; ++step) load_step(step);

  // this thread's two rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t v_smem = sm90::smem_addr(sV);

  float acc_o[kMmaChunk / kBlock][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c) acc_o[c][i] = 0.f;
  }
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kAhead - 1>();  // this step's group has landed
    sm90::fence_proxy_async();
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kAhead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S (+)= Q K^T over this block's 64 columns
      const uint32_t q_smem = sm90::smem_addr(
          sQK + (it * nb + blk) % kRing * 2 * kTile * kBlock);
      const uint32_t k_smem = q_smem + kTile * kBlock * (uint32_t)sizeof(T);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile>(q_smem, kk),
                                 sm90::desc_k_major<kTile>(k_smem, kk),
                                 blk > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      continue;
    }

    float alpha_a, alpha_b;
    softmax_step(s, q0, it * kTile, row_a, row_b, t, L, causal, scale_log2,
                 m_a, m_b, l_a, l_b, alpha_a, alpha_b);
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_o[c][i] *= (i & 2) ? alpha_b : alpha_a;

    // O[:, chunk] += P V[:, chunk], P rounded to the input dtype from
    // registers; V read MN-major
    uint32_t ap[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ap[kk], s + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kMmaChunk / kBlock; ++c)
        if (c < nc)
          sm90::wgmma_rs_mn<T>(acc_o[c], ap[kk],
                               sm90::desc_mn_major<kTile>(v_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c)
      sm90::fence_operands(acc_o[c]);
  }

  float inv_a, inv_b;
  finish_rows(l_a, l_b, inv_a, inv_b);
  T* out = o + (size_t)bh * L * D;
#pragma unroll
  for (int c = 0; c < kMmaChunk / kBlock; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + kBlock * c + 8 * j + 2 * t;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
            sm90::pack2<T>(acc_o[c][4 * j] * inv_a,
                           acc_o[c][4 * j + 1] * inv_a);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
            sm90::pack2<T>(acc_o[c][4 * j + 2] * inv_b,
                           acc_o[c][4 * j + 3] * inv_b);
    }
  }
  if (chunk == 0)
    store_lse(lse + (size_t)bh * L, row_a, row_b, L, t, m_a, m_b, l_a, l_b);
}

// ---------------------------------------------------------------------------
// fp32: register-tiled SIMT kernel (flash_fwd_f32_kernel), for any D that is
// a multiple of 32 and at least 64 (the wrapper zero-pads to one)
//
// Full fp32 FMAs, as the twin computes: single-pass TF32 keeps about three
// decimal digits and would break the fp32 limit of 1e-4 (3xTF32 on wgmma is
// the later route to measure against this one). It is the fp32 K3g's
// design (flash_bwd.cu) carried over to the forward:
//   - A block of 256 threads owns one 64-row q tile of one b * Hq + h, one
//     256-column chunk of O (kF32Chunk; the last chunk narrower where D is
//     not a multiple of 256) and one slab of the tile's k tiles.
//   - S = Q K^T: Q and K stream in 32-column blocks through the ring of
//     simt.cuh (3 stages, loads two steps ahead, rows padded to 36 floats).
//     Each thread owns a 4 x 4 tile of S, queries 8 w + 4 (lane / 16) .. + 3
//     and keys lane % 16 + 16 i of warp w (simt::f32_tile_product): a query
//     row's 16 owners share one half-warp, so the row max and the row sum
//     reduce by shuffles. One 16-byte load of a warp reads two Q rows
//     (broadcast) or 16 K rows (two wavefronts, the least for 256 bytes).
//   - The online softmax runs on that tile after the tile's last block
//     step, in fp32 with expf, as the twin; each thread keeps its part of l
//     (reduced over the 16 owners once, at the end). P goes through shared
//     memory as P^T ([key][query], rows padded to 68 floats, one 16-byte
//     store per key), with each row's alpha beside it.
//   - O += P V: each thread owns an 8 x 8 tile of the block's 64 x 256 fp32
//     O chunk (64 registers): rows 32 (w % 2) + 8 (lane % 4) .. + 7, columns
//     64 (w / 2) + 4 (lane / 4) .. + 3 and + 32 .. + 35, so that per key it
//     loads 8 P and 8 V floats in four 16-byte loads (one wavefront each)
//     for 64 FMAs. V's chunk (64 keys x 256 columns, 64 KB) arrives in
//     quarters with the last block steps of S, as K3g's dO chunk does.
//     Warps whose columns lie past a narrow chunk (D <= 192, or the last
//     chunk) skip the product: splitting the keys among them instead, with
//     a sum at the end, measured no faster (PERF.md).
//   - Work: S once per chunk and P V once, 2 D ceil(D / 256) + 2 D
//     operations a (q, k) pair: 4 D at D <= 256, 6 D at D = 512.
//   - Load balance: the grid is tile-major, the longest causal q tile
//     first. Where one block per (q tile, chunk, head) cannot fill the
//     card, a tile's k tiles are cut into slabs of per_slab (the wrapper's
//     fwd_split, from the shapes and the card's SM count). With one slab a
//     block writes O and the lse itself. With more each block writes an fp32
//     partial (O unnormalised, and the row's m and l from chunk 0), and a
//     second launch (flash_fwd_split_combine_kernel) merges each row's slabs
//     in slab order: no atomics, the same bits on every run. A slab past its
//     tile's k tiles exits at once.
//   - Shared memory: ring 55 KB, V's chunk 64 KB, P^T 17 KB: 136 KB, one
//     block an SM (218 registers a thread, no spill).
//   - Bound: 4 D operations a pair at SIMT's 67 TFLOP/s (at B2 Hq8 Hkv2
//     L1024 D256 causal, 8.6 GFLOP, 0.128 ms). What holds it is K3g's
//     limit: an SM moves 32 floats a cycle from shared memory to registers
//     for 128 FMA lanes, so the 4 x 4 S tile (2 FMAs a float loaded) runs at
//     about half the FMA rate and the 8 x 8 product (4 a float) at about two
//     thirds; then the loads, whose latency the ring leaves partly exposed
//     (PERF.md: S, the product and the loads measured apart).

using simt::kF32Ahead;
using simt::kF32Block;
using simt::kF32Ring;
using simt::kF32Row;
using simt::kF32Threads;
using simt::load_f32_block;
constexpr int kF32Chunk = 256;       // O columns a block accumulates
constexpr int kF32PRow = kTile + 4;  // floats of a row of P^T
// one ring stage: a Q and a K block (kTile rows each)
constexpr int kF32Stage = 2 * kTile * kF32Row;
static_assert(simt::kF32Rows == kTile, "a staged block is one q or k tile");

constexpr size_t f32_smem_bytes() {
  // the ring, V's chunk, P^T, each row's alpha and l
  return sizeof(float) * (size_t)(kF32Ring * kF32Stage + kTile * kF32Chunk +
                                  kTile * kF32PRow + 2 * kTile);
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ o_part,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     int Hq, int Hkv, int L, int D, float scale, int causal,
                     int per_slab, int slabs) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sRing = reinterpret_cast<float*>(smem_raw);
  float* sV = sRing + kF32Ring * kF32Stage;  // V's chunk, kTile x kF32Chunk
  float* sPT = sV + kTile * kF32Chunk;       // P^T, [key][query]
  float* sAlpha = sPT + kTile * kF32PRow;    // kTile
  float* sL = sAlpha + kTile;                // kTile

  const int tid = threadIdx.x;
  const int nq = (L + kTile - 1) / kTile;
  const int nb = D / kF32Block;  // the blocks S reduces over
  const int chunks = (D + kF32Chunk - 1) / kF32Chunk;
  const int heads = gridDim.x / (nq * slabs * chunks);  // B * Hq
  const int bh = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads % chunks;
  const int slab = blockIdx.x / (heads * chunks) % slabs;
  const int rank = blockIdx.x / (heads * chunks * slabs);
  // causal: the last q tile walks every k tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  // the q tile's k tiles (causal: up to the diagonal); this slab's share
  const int n_k = causal ? q0 / kTile + 1 : nq;
  const int it0 = slab * per_slab;
  if (it0 >= n_k) return;  // the tile needs fewer slabs
  const int n_it = min(per_slab, n_k - it0);
  const int per = nb + 1;  // nb block steps and the softmax / P V step
  const int n_steps = n_it * per;
  const int c0 = chunk * kF32Chunk;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)kvh * L * D;
  const float* vb = v + (size_t)kvh * L * D;

  // one step's loads as one cp.async group (empty past the last step). A
  // ring stage is refilled kF32Ring block steps after its last use; V's
  // chunk quarters go with block steps max(kF32Ahead, nb - 3 + m), so all
  // are started no earlier than the first step of their k tile, after the
  // last P V read the previous chunk
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      const int k0 = (it0 + it) * kTile;
      if (blk < nb) {
        float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
        load_f32_block(stage, qb, q0, L, D, kF32Block * blk);
        load_f32_block(stage + kTile * kF32Row, kb, k0, L, D,
                       kF32Block * blk);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (blk != max(kF32Ahead, nb - 3 + m)) continue;
        // keys [16 m, 16 m + 16) of the chunk, 64 16-byte pieces a row;
        // columns past D are zero
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = tid + j * kF32Threads;
          const int r = 16 * m + (i >> 6), col = c0 + 4 * (i & 63);
          const bool ok = k0 + r < L && col < D;
          sm90::cp_async_16(sV + r * kF32Chunk + 4 * (i & 63),
                            vb + (ok ? (size_t)(k0 + r) * D + col : 0),
                            ok ? 16 : 0);
        }
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kF32Ahead; ++step) load_step(step);

  const int warp = tid >> 5, lane = tid & 31;
  // S tile: queries tq .. tq + 3, keys tk + 16 i (f32_tile_product)
  const int tq = 8 * warp + 4 * (lane >> 4);
  const int tk = lane & 15;
  // product tile: queries pq .. pq + 7, columns pc .. pc + 3 and pc + 32 ..
  // pc + 35 of the chunk; warps past a narrow last chunk have none
  const int pq = 32 * (warp & 1) + 8 * (lane & 3);
  const int pc = 64 * (warp >> 1) + 4 * (lane >> 2);
  const bool has_cols = c0 + 64 * (warp >> 1) < D;
  float acc[8][8], s[4][4];
  float m[4], l[4];  // the row max and this thread's part of the row sum
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
  }

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kF32Ahead - 1>();  // this step's group has landed
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kF32Ahead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S (+)= Q K^T over this block's 32 columns
      const float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
      if (blk == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      }
      simt::f32_tile_product<1, 16>(s, stage + tq * kF32Row,
                                    stage + (kTile + tk) * kF32Row);
      continue;
    }

    // the online softmax on the S tile: masked where the k tile crosses
    // the diagonal or the end of the sequence
    const int k0 = (it0 + it) * kTile;
    const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > L;
    float alpha[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale;
        if (edge) {
          const int key = k0 + tk + 16 * i;
          if (key >= L || (causal && key > q0 + tq + j)) x = kNeg;
        }
        s[j][i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int lanes = 1; lanes <= 8; lanes <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lanes));
      const float next = fmaxf(m[j], mx);
      alpha[j] = expf(m[j] - next);
      m[j] = next;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = s[j][i] > kNeg ? expf(s[j][i] - next) : 0.f;
        s[j][i] = p;
        sum += p;
      }
      l[j] = alpha[j] * l[j] + sum;
    }
    // P^T and alpha into shared memory, for the product tiles' rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sPT + (tk + 16 * i) * kF32PRow + tq) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    if (tk == 0)
      *reinterpret_cast<float4*>(sAlpha + tq) =
          make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
    __syncthreads();

    // O[:, chunk] = alpha O[:, chunk] + P V[:, chunk]
    if (!has_cols) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(sAlpha + pq);
    const float4 a1 = *reinterpret_cast<const float4*>(sAlpha + pq + 4);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= ar[r];
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      const float* prow = sPT + key * kF32PRow + pq;
      const float* vrow = sV + key * kF32Chunk + pc;
      const float4 p0 = *reinterpret_cast<const float4*>(prow);
      const float4 p1 = *reinterpret_cast<const float4*>(prow + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(vrow);
      const float4 x1 = *reinterpret_cast<const float4*>(vrow + 32);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pr[r], vr[c], acc[r][c]);
    }
  }

  // l over the row's 16 owners; the lse, or this slab's m and l (chunk 0)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int lanes = 1; lanes <= 8; lanes <<= 1)
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], lanes);
  const size_t stats = ((size_t)slab * heads + bh) * L;
  if (tk == 0) {
    *reinterpret_cast<float4*>(sL + tq) = make_float4(l[0], l[1], l[2], l[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tq + j;
      if (chunk != 0 || row >= L) continue;
      if (slabs == 1) {
        lse[(size_t)bh * L + row] = m[j] + logf(fmaxf(l[j], 1e-30f));
      } else {
        m_part[stats + row] = m[j];
        l_part[stats + row] = l[j];
      }
    }
  }
  __syncthreads();
  if (!has_cols) return;

  // rows pq .. pq + 7 of the q tile, columns c0 + pc and c0 + pc + 32: into
  // O divided by l (a row with no unmasked key has l == 0: 0, not nan), or
  // into this slab's partial as they are
  float* out = slabs == 1 ? o + (size_t)bh * L * D : o_part + stats * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + pq + r;
    if (row >= L) break;
    float inv = 1.f;
    if (slabs == 1) {
      const float lr = sL[pq + r];
      inv = lr == 0.f ? 0.f : 1.f / lr;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + pc + 32 * h;
      if (col < D)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
            make_float4(acc[r][4 * h] * inv, acc[r][4 * h + 1] * inv,
                        acc[r][4 * h + 2] * inv, acc[r][4 * h + 3] * inv);
    }
  }
}

// the second launch of a split fp32 K1: each row of O and its lse from the
// q tile's slabs of partials (o_part (slabs, B * Hq, L, D), m_part and
// l_part (slabs, B * Hq, L)), merged in slab order: m = max m_s, l = sum
// l_s e^(m_s - m), O = sum O_s e^(m_s - m) / l, lse = m + log l. A slab in
// which a row has no unmasked key (m_s = -1e30, l_s = 0, O_s = 0) adds 0.
// Memory-bound: it reads every slab's partial once.
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_split_combine_kernel(const float4* __restrict__ o_part,
                               const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               float4* __restrict__ o,
                               float* __restrict__ lse, int rows, int L,
                               int D, int causal, int per_slab) {
  const int per_row = D / 4;  // float4s of a row
  const size_t total = (size_t)rows * per_row;
  const int nq = (L + kTile - 1) / kTile;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / per_row;  // bh * L + query
    const int tile = (int)(row % L) / kTile;
    const int n = ((causal ? tile + 1 : nq) + per_slab - 1) / per_slab;
    float m = kNeg;
    for (int sl = 0; sl < n; ++sl)
      m = fmaxf(m, m_part[(size_t)sl * rows + row]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sl = 0; sl < n; ++sl) {
      const float w = expf(m_part[(size_t)sl * rows + row] - m);
      const float4 x = o_part[(size_t)sl * total + i];
      l += l_part[(size_t)sl * rows + row] * w;
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    o[i] = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    if (i % per_row == 0) lse[row] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, Hq, Hkv, L;
  int ld;  // the tuned builds: the caller's row length, at most D
  int rows;  // q rows of a block of the D = 256 build: 64 or 128
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// one block per (tile, head): tile-major, so the tile rank is the slow index
template <typename T, int D>
int launch_mma(const Args& a) {
  const size_t smem = mma_smem_bytes<D>();
  if (int err = prepare(flash_fwd_mma_kernel<T, D>, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  flash_fwd_mma_kernel<T, D><<<(int)grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv,
      a.L, a.ld, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// D = 256 on its two-warpgroup kernel, over q tiles of the caller's rows:
// 128, or 64 (warpgroup 1 idle) where the caller's rule (fwd_rows in
// ops/flash_attention.py) keeps a small grid's blocks
template <typename T>
int launch_mma_256(const Args& a) {
  const size_t smem = mma_256_smem_bytes();
  if (int err = prepare(flash_fwd_mma_256_kernel<T>, smem)) return err;
  const long long grid =
      (long long)((a.L + a.rows - 1) / a.rows) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  flash_fwd_mma_256_kernel<T><<<(int)grid, kMma256Threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv,
      a.L, a.ld, a.scale, a.causal, a.rows);
  return (int)cudaGetLastError();
}

// one block per (q tile, slab, chunk, head): tile-major, so the tile rank is
// the slow index
int launch_f32(const Args& a, int D, float* o_part, float* m_part,
               float* l_part, int per_slab, int slabs) {
  const size_t smem = f32_smem_bytes();
  if (int err = prepare(flash_fwd_f32_kernel, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * slabs *
                         ((D + kF32Chunk - 1) / kF32Chunk) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  flash_fwd_f32_kernel<<<(int)grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, o_part,
      m_part, l_part, a.Hq, a.Hkv, a.L, D, a.scale, a.causal, per_slab,
      slabs);
  return (int)cudaGetLastError();
}

// one block per (q tile, chunk, head): tile-major, so the tile rank is the
// slow index
template <typename T>
int launch_general_mma(const Args& a, int D) {
  const size_t smem = general_mma_smem_bytes();
  if (int err = prepare(flash_fwd_general_mma_kernel<T>, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) *
                         ((D + kMmaChunk - 1) / kMmaChunk) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  flash_fwd_general_mma_kernel<T>
      <<<(int)grid, kMmaThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq,
          a.Hkv, a.L, D, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on tensor cores: dtype 1 = float16, 2 = bfloat16; the build D in {16,
// 32, 64, 128, 256}. Returns 0 on success, the cudaError_t of a refused
// launch, or -1 for arguments the kernel does not take (the Python wrapper
// checks them first). q and o are (B, Hq, L, ld), k and v (B, Hkv, L, ld),
// lse (B, Hq, L) fp32, with ld <= D a multiple of 8 (the build zero-fills
// columns ld..D - 1 in shared memory and stores ld columns of o); all
// contiguous, and q, k and v 16-byte aligned. rows: the q rows of a block,
// 64, or 128 at the D = 256 build (two warpgroups of 64).
int metisfl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Hq, int Hkv, int L, int D,
                      int ld, int rows, int dtype, int causal,
                      float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1 || ld < 8 || ld > D ||
      ld % 8 != 0 || (rows != kTile && (rows != kMma256Rows || D != 256)))
    return -1;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, ld,
               rows, scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype * 1000 + D) {
    case 1016:
      return launch_mma<__half, 16>(a);
    case 1032:
      return launch_mma<__half, 32>(a);
    case 1064:
      return launch_mma<__half, 64>(a);
    case 1128:
      return launch_mma<__half, 128>(a);
    case 1256:
      return launch_mma_256<__half>(a);
    case 2016:
      return launch_mma<__nv_bfloat16, 16>(a);
    case 2032:
      return launch_mma<__nv_bfloat16, 32>(a);
    case 2064:
      return launch_mma<__nv_bfloat16, 64>(a);
    case 2128:
      return launch_mma<__nv_bfloat16, 128>(a);
    case 2256:
      return launch_mma_256<__nv_bfloat16>(a);
    default:
      return -1;
  }
}

// K1 in fp32 (dtype 0), register-tiled, at any head dim D that is a
// multiple of 32 and at least 64 (the wrapper zero-pads to one), with
// metisfl_flash_fwd's arguments and the split: each q tile's k tiles are
// cut into slabs of per_slab (slabs for the longest tile). slabs = 1
// writes o and lse; slabs > 1 writes fp32 partials, o_part (slabs, B, Hq,
// L, D) unnormalised and m_part, l_part (slabs, B, Hq, L), which
// metisfl_flash_fwd_split_combine then merges. The (B, H, L, D) tensors
// contiguous and 16-byte aligned.
int metisfl_flash_fwd_general(const void* q, const void* k, const void* v,
                              void* o, void* lse, void* o_part, void* m_part,
                              void* l_part, int B, int Hq, int Hkv, int L,
                              int D, int dtype, int causal, int per_slab,
                              int slabs, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1 || dtype != 0 ||
      D % kF32Block != 0 || D / kF32Block < kF32Ahead || per_slab < 1 ||
      slabs < 1 ||
      (slabs > 1 && (o_part == nullptr || m_part == nullptr ||
                     l_part == nullptr)))
    return -1;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, D,
               kTile, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch_f32(a, D, static_cast<float*>(o_part),
                    static_cast<float*>(m_part), static_cast<float*>(l_part),
                    per_slab, slabs);
}

// The second launch of a split fp32 K1: o (B, Hq, L, D) and lse (B, Hq, L)
// from the partials of metisfl_flash_fwd_general with the same shapes,
// causal and per_slab; D a multiple of 4, every tensor 16-byte aligned.
int metisfl_flash_fwd_split_combine(const void* o_part, const void* m_part,
                                    const void* l_part, void* o, void* lse,
                                    int B, int Hq, int L, int D, int causal,
                                    int per_slab, void* stream) {
  if (B < 1 || Hq < 1 || L < 1 || D < 4 || D % 4 != 0 || per_slab < 1)
    return -1;
  const long long rows = (long long)B * Hq * L;
  if (rows > INT_MAX) return -1;
  const long long float4s = rows * D / 4;
  const int grid = (int)std::min<long long>(
      (float4s + kF32Threads - 1) / kF32Threads, 16384);
  flash_fwd_split_combine_kernel<<<grid, kF32Threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float4*>(o),
      static_cast<float*>(lse), (int)rows, L, D, causal, per_slab);
  return (int)cudaGetLastError();
}

// K1 on tensor cores in bf16 (dtype 2) or fp16 (1) at any head dim D that
// is a multiple of 64 and at least 128 (the wrapper zero-pads to one), with
// metisfl_flash_fwd's arguments: one block per (64-row q tile, 256-column
// chunk of O, b * Hq + h); q, k and v contiguous and 16-byte aligned.
int metisfl_flash_fwd_general_mma(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int Hq, int Hkv, int L, int D, int dtype,
                                  int causal, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1 || D % kBlock != 0 ||
      D / kBlock < kAhead)
    return -1;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, D,
               kTile, scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch_general_mma<__half>(a, D);
    case 2: return launch_general_mma<__nv_bfloat16>(a, D);
    default: return -1;
  }
}

const char* metisfl_cuda_error_string(int err) {
  return err < 0 ? "invalid argument" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
