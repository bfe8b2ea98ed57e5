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
//     reduction runs over keys), one wgmma per 64-column block of D. O
//     stays in fp32 registers (32 per thread at D = 64, 64 at D = 128, 128
//     at D = 256) until one store.
//   - Head dims 64, 128 and 256, the tile shapes unchanged (64-row q and
//     K/V tiles): shared memory holds Q and two K/V stages in 40, 80 and
//     160 KB (the SIMT kernel's fp32 tiles 52, 104 and 209 KB), under the
//     227 KB a block may use. The wrapper pads any other D up to 256 to
//     one of them; a larger D goes to the general tensor-core kernel
//     (flash_fwd_general_mma_kernel, below), whose Q and K stream through
//     shared memory 64 columns at a time, so that no D is too large.
//   - Causal work is uneven (the last q tile walks every K tile), so the
//     1-D grid hands out the longest tiles first. No atomics: the same bits
//     on every run.
//   - Not yet: TMA loads, warp specialisation (a producer warp and two
//     consumer warpgroups in ping-pong), keeping the next tile's Q K^T in
//     flight across this tile's softmax, and staging O through shared
//     memory for 16-byte stores; each step waits for its products.
//
// fp32: the SIMT kernel (flash_fwd_simt_kernel), a deliberate choice by
// dtype: TF32 tensor cores keep 10 bits of mantissa, which the fp32
// tolerance and the JAX package's fp32 numerics do not allow. One block of
// 256 threads owns one (64-row q tile, b * Hq + h); four threads own one
// query row, each computing 16 of a K tile's 64 scores and D/4 of the
// output columns, with the row's max and sum reduced over the four lanes by
// shuffles. Q, K and V are staged in shared memory with rows padded to
// D + 1 floats. Beyond the fp32 builds (D > 256) the general SIMT kernel
// (flash_fwd_general_kernel) takes any D.

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
// fp32: SIMT kernel

constexpr int kThreads = 256;  // 4 threads per query row

template <int D>
constexpr size_t simt_smem_bytes() {
  // Q and K rows padded by one float so the four lanes of a row (and the
  // eight rows of a warp) fall in distinct banks; P padded likewise.
  return sizeof(float) * (size_t)(kTile * (D + 1) + kTile * (D + 1) +
                                  kTile * D + kTile * (kTile + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int Hq, int Hkv, int L,
                      float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                        // kTile x (D + 1)
  float* sK = sQ + kTile * (D + 1);        // kTile x (D + 1)
  float* sV = sK + kTile * (D + 1);        // kTile x D
  float* sP = sV + kTile * D;              // kTile x (kTile + 1)

  const int tid = threadIdx.x;
  const int row = tid >> 2;       // query row inside the tile
  const int sub = tid & 3;        // which quarter of the row's columns
  const int bh = blockIdx.y;      // b * Hq + h
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int q_pos = q0 + row;

  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)kvh * L * D;
  const float* vb = v + (size_t)kvh * L * D;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int g = q0 + r;
    sQ[r * (D + 1) + d] = g < L ? qb[(size_t)g * D + d] : 0.f;
  }

  float m = kNeg, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  // causal: the last key tile that overlaps this q tile (q0 + kTile - 1)
  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous step is done with sK / sV
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      const int g = k0 + r;
      const bool in = g < L;
      sK[r * (D + 1) + d] = in ? kb[(size_t)g * D + d] : 0.f;
      sV[r * D + d] = in ? vb[(size_t)g * D + d] : 0.f;
    }
    __syncthreads();

    float s[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) s[j] = 0.f;
    const float* qrow = sQ + row * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j)
        s[j] = fmaf(qd, sK[(sub + 4 * j) * (D + 1) + d], s[j]);
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const int k_pos = k0 + sub + 4 * j;
      const bool ok = k_pos < L && (!causal || q_pos >= k_pos);
      s[j] = ok ? s[j] * scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m, mx);
    const float alpha = expf(m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const float p = s[j] > kNeg ? expf(s[j] - m_next) : 0.f;
      psum += p;
      sP[row * (kTile + 1) + sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_next;
    __syncwarp();  // a row's P is written and read by the same four lanes

    const float* prow = sP + row * (kTile + 1);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * D + sub;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (q_pos < L) {
    // a row with no unmasked key has l == 0: store 0, not nan
    const float inv = l == 0.f ? 0.f : 1.f / l;
    float* orow = o + ((size_t)bh * L + q_pos) * D + sub;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[4 * j] = acc[j] * inv;
    if (sub == 0) lse[(size_t)bh * L + q_pos] = m + logf(fmaxf(l, 1e-30f));
  }
}

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

// lse = m ln 2 + log l of rows row_a and row_b, from one lane of the four
__device__ __forceinline__ void store_lse(float* lse_bh, int row_a, int row_b,
                                          int L, int t, float m_a, float m_b,
                                          float l_a, float l_b) {
  if (t != 0) return;
  if (row_a < L) lse_bh[row_a] = m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
  if (row_b < L) lse_bh[row_b] = m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
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
                     float* __restrict__ lse, int Hq, int Hkv, int L,
                     float scale, int causal) {
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
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sQ, q + (size_t)bh * L * D, q0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sK, kb, 0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sV, vb, 0, L);
  sm90::cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_smem = sm90::smem_addr(sQ);

  float acc_o[D / 64][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc_o[c][i] = 0.f;
  }
  // running max (base 2) and this thread's part of the running sum
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int n_k = (k_end + kTile - 1) / kTile;
  for (int it = 0; it < n_k; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_k) {
      const int next = (it + 1) * kTile;
      sm90::load_tile_async<T, D, kTile, kMmaThreads>(
          sK + (stage ^ 1) * kTile * D, kb, next, L);
      sm90::load_tile_async<T, D, kTile, kMmaThreads>(
          sV + (stage ^ 1) * kTile * D, vb, next, L);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this stage (and Q) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int k0 = it * kTile;
    const uint32_t k_smem = sm90::smem_addr(sK + stage * kTile * D);
    const uint32_t v_smem = sm90::smem_addr(sV + stage * kTile * D);

    // S = Q K^T, 64 rows x 64 keys, K read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile>(q_smem, kk),
                               sm90::desc_k_major<kTile>(k_smem, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    float alpha_a, alpha_b;
    softmax_step(s, q0, k0, row_a, row_b, t, L, causal, scale_log2, m_a, m_b,
                 l_a, l_b, alpha_a, alpha_b);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_o[c][i] *= (i & 2) ? alpha_b : alpha_a;

    // O += P V, P rounded to the input dtype from registers; V read
    // MN-major ([key][d], the reduction runs over keys)
    uint32_t ap[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ap[kk], s + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm90::wgmma_rs_mn<T>(acc_o[c], ap[kk],
                             sm90::desc_mn_major<kTile>(v_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) sm90::fence_operands(acc_o[c]);
    __syncthreads();  // done with this stage before it is refilled
  }

  float inv_a, inv_b;
  finish_rows(l_a, l_b, inv_a, inv_b);
  T* out = o + (size_t)bh * L * D;
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
            sm90::pack2<T>(acc_o[c][4 * j] * inv_a,
                           acc_o[c][4 * j + 1] * inv_a);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
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
// registers a thread. At D = 512, Q (64 KB), two K stages (128 KB) and two V
// stages (128 KB) would not fit the 227 KB of shared memory a block may use,
// and O would need 256 registers a thread. So:
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
// fp32 beyond the builds (D > 256): SIMT kernel (flash_fwd_general_kernel)
//
// One block of 256 threads per (64-row q tile, b * Hq + h, 64-column chunk
// of O's D); four threads own one query row, as in the fp32 SIMT kernel.
// Each block computes S over the full D, 64 columns at a time through
// shared memory, runs the online softmax, and accumulates only its own
// chunk of O = P V. Every chunk of a tile repeats the same S, m and l, bit
// for bit; the first writes the lse.
// Bound: 4 D operations a (q, k) pair, at SIMT's 67 TFLOP/s (at B1 Hq4 L512
// D512 causal, 1.1 GFLOP, 0.016 ms). It recomputes S once per output
// chunk, D / 64 times: a right kernel for fp32 head dims the builds do not
// cover, not a fast one.

constexpr int kChunk = simt::kChunk;
constexpr int kChunkTile = kTile * (kChunk + 1);  // floats of one tile

constexpr size_t general_smem_bytes() {
  // Q, K and V chunk tiles and the P tile
  return sizeof(float) * (size_t)(3 * kChunkTile + kTile * (kTile + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_general_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Hq, int Hkv, int L,
                         int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kChunkTile;
  float* sV = sK + kChunkTile;
  float* sP = sV + kChunkTile;  // kTile x (kTile + 1)

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int d0 = blockIdx.z * kChunk;
  const int q_pos = q0 + row;

  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)kvh * L * D;
  const float* vb = v + (size_t)kvh * L * D;

  float m = kNeg, l = 0.f;
  float acc[kChunk / 4];
#pragma unroll
  for (int j = 0; j < kChunk / 4; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      __syncthreads();  // the previous step is done with the tiles
      simt::load_chunk<kTile, kThreads>(sQ, qb, q0, L, c0, D);
      simt::load_chunk<kTile, kThreads>(sK, kb, k0, L, c0, D);
      __syncthreads();
      const float* qrow = sQ + row * (kChunk + 1);
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        const float qd = qrow[d];
#pragma unroll
        for (int j = 0; j < kTile / 4; ++j)
          s[j] = fmaf(qd, sK[(sub + 4 * j) * (kChunk + 1) + d], s[j]);
      }
    }
    // every thread passed the loop's last barrier after the previous
    // step's P V, so sV may be refilled
    simt::load_chunk<kTile, kThreads>(sV, vb, k0, L, d0, D);

    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const int k_pos = k0 + sub + 4 * j;
      const bool ok = k_pos < L && (!causal || q_pos >= k_pos);
      s[j] = ok ? s[j] * scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m, mx);
    const float alpha = expf(m - m_next);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const float p = s[j] > kNeg ? expf(s[j] - m_next) : 0.f;
      psum += p;
      sP[row * (kTile + 1) + sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_next;
    __syncthreads();  // sV is loaded; a row's P is written by its lanes

    const float* prow = sP + row * (kTile + 1);
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * (kChunk + 1) + sub;
#pragma unroll
      for (int j = 0; j < kChunk / 4; ++j)
        acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (q_pos < L) {
    // a row with no unmasked key has l == 0: store 0, not nan
    const float inv = l == 0.f ? 0.f : 1.f / l;
    float* orow = o + ((size_t)bh * L + q_pos) * D;
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      const int col = d0 + sub + 4 * j;
      if (col < D) orow[col] = acc[j] * inv;
    }
    if (sub == 0 && blockIdx.z == 0)
      lse[(size_t)bh * L + q_pos] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, Hq, Hkv, L;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_simt(const Args& a) {
  const size_t smem = simt_smem_bytes<D>();
  if (int err = prepare(flash_fwd_simt_kernel<D>, smem)) return err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hq);
  flash_fwd_simt_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Hq,
      a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// one block per (tile, head): tile-major, so the tile rank is the slow index
template <typename T, int D>
int launch_mma(const Args& a) {
  const size_t smem = mma_smem_bytes<D>();
  if (int err = prepare(flash_fwd_mma_kernel<T, D>, smem)) return err;
  const int grid = (a.L + kTile - 1) / kTile * a.B * a.Hq;
  flash_fwd_mma_kernel<T, D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Hq, a.Hkv,
      a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

int launch_general(const Args& a, int D) {
  const size_t smem = general_smem_bytes();
  if (int err = prepare(flash_fwd_general_kernel, smem)) return err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hq,
                  (D + kChunk - 1) / kChunk);
  flash_fwd_general_kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Hq,
      a.Hkv, a.L, D, a.scale, a.causal);
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

// dtype: 0 = float32 (SIMT), 1 = float16, 2 = bfloat16 (tensor cores); D in
// {64, 128, 256}. Returns 0 on success, the cudaError_t of a refused launch, or -1
// for arguments the kernel does not take (the Python wrapper checks them
// first). q and o are (B, Hq, L, D), k and v (B, Hkv, L, D), lse (B, Hq, L)
// fp32; all contiguous, and for bf16/fp16 q, k and v 16-byte aligned.
int metisfl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Hq, int Hkv, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1) return -1;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, scale,
               causal, static_cast<cudaStream_t>(stream)};
  switch (dtype * 1000 + D) {
    case 64:
      return launch_simt<64>(a);
    case 128:
      return launch_simt<128>(a);
    case 256:
      return launch_simt<256>(a);
    case 1064:
      return launch_mma<__half, 64>(a);
    case 1128:
      return launch_mma<__half, 128>(a);
    case 1256:
      return launch_mma<__half, 256>(a);
    case 2064:
      return launch_mma<__nv_bfloat16, 64>(a);
    case 2128:
      return launch_mma<__nv_bfloat16, 128>(a);
    case 2256:
      return launch_mma<__nv_bfloat16, 256>(a);
    default:
      return -1;
  }
}

// K1 in fp32 at any head dim D >= 1 (SIMT, one block per 64-column chunk
// of O), with metisfl_flash_fwd's arguments; no alignment is needed.
int metisfl_flash_fwd_general(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Hq, int Hkv,
                              int L, int D, int dtype, int causal,
                              float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1 || D < 1 || dtype != 0)
    return -1;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return launch_general(a, D);
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
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, L, scale,
               causal, static_cast<cudaStream_t>(stream)};
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
