// Flash-attention backward for Hopper (sm_90a): the dQ kernel (K2) and the
// dK/dV kernel (K3), bound through a plain C interface and loaded with
// ctypes (metisfl_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernels metisfl_tpu/ops/flash_attention.py:_dq_kernel and
// :_dkv_kernel (launched by _flash_backward through pl.pallas_call). Both
// recompute the probabilities from the forward's logsumexp, as the TPU
// kernels do (FlashAttention-2), so no (L, L) matrix reaches device memory:
//   P  = exp(scale * Q K^T - lse)          (masked: causal, k_pos < L)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale          with delta = rowsum(dO * O) in fp32
//   K2: dQ  = sum over K tiles of dS K
//   K3: dV  = sum over the group's query heads and Q tiles of P^T dO
//       dK  = sum over the same of dS^T Q
// They round where the TPU kernels round: dS to the input dtype before
// dS K and dS^T Q, P to the input dtype before P^T dO.
//
// Bound at the training shape (B=8, Hq=16, Hkv=4, L=1024, D=64, bf16,
// causal; 524,800 (q, k) pairs per head, 128 heads): K2 does 6 D operations
// per pair, 25.8 GFLOP, 26 us at 989 TFLOP/s; K3 does 8 D, 34.4 GFLOP,
// 35 us; each moves about 60 MB (18 us at 3.35 TB/s). So both are bound by
// the tensor cores' rate, and every product has to run on them.
//
// bf16 and fp16: tensor-core kernels (flash_bwd_*_mma_kernel, and
// flash_bwd_dq_mma_256_kernel and flash_bwd_dkv_mma_256_kernel for K2 and
// K3 at D = 256).
//   - Every product is wgmma.mma_async m64nNk16 with fp32 accumulation,
//     issued by one warpgroup of 4 warps for the block's 64-row tile (warp
//     w owns rows 16 w..16 w + 15; K2 and K3 at D = 256 have two
//     warpgroups).
//     Both operands of QK^T and dO V^T come from shared memory through
//     matrix descriptors (sm90.cuh); P and dS
//     are rounded to the input dtype in registers and are the A operand of
//     the next product: that conversion is the TPU kernels' cast.
//   - K3 computes S^T = K Q^T and dP^T = V dO^T with key rows as M, so P^T
//     and dS^T come out already laid out as the A operand of dV += P^T dO
//     and dK += dS^T Q; there Q and dO are read MN-major (the reduction
//     runs over query rows). K2 computes S = Q K^T and dP = dO V^T and
//     reads K K-major for Q K^T and MN-major for dS K. All tiles use the
//     128-byte swizzle, in 64-column blocks, which serves both readings.
//   - Loads overlap compute: the streamed side (K3: Q, dO, lse, delta of
//     the next q tile; K2: K, V of the next k tile) goes through a
//     two-stage ring in shared memory filled by cp.async (16 bytes per
//     thread, zero-filled past L, so ragged L needs no padded copy); the
//     resident side (K3: K, V; K2: Q, dO, lse, delta) is loaded once.
//   - Masks are computed from each accumulator element's (row, column)
//     under the wgmma fragment layout, and only on tiles that cross the
//     causal diagonal or the end of the sequence.
//   - K3 keeps dK and dV in fp32 registers across its whole loop over the G
//     query heads of the group and the q tiles that overlap its k tile;
//     K2 writes dQ once per tile. No atomics: the same bits on every run.
//   - Causal work is uneven (K3's first k tile walks every q tile, its last
//     one; K2 the mirror image), so the 1-D grid hands out the longest
//     tiles first.
//   - D = 128 in K3 streams 32-row q tiles, so that dK, dV (128 fp32 per
//     thread) and the 64x32 S^T and dP^T fit in registers without spills.
//   - K2 and K3 at D = 16 and 32 (bf16/fp16): a tile's row is one column
//     block of 32 or 64 bytes in wgmma's 32- and 64-byte swizzles
//     (sm90.cuh), S and dP (K3: S^T and dP^T) take D / 16 k-steps (one at
//     D = 16) and dQ += dS K (K3: dV += P^T dO and dK += dS^T Q) are n = D
//     products, so no step runs on zero columns; dQ is 8 or 16 fp32 a
//     thread (K3: dK and dV 8 + 8 or 16 + 16), and a block takes 12 or 24
//     KB of shared memory (K3: 13 or 26). The builds read the caller's rows
//     at their own length ld (a multiple of 8 up to D): cp.async zero-fills
//     columns ld.. and only ld columns are stored, so D = 8 and 24 need no
//     padded copy. K2's grid (one block per q tile and query head) is left
//     whole. K3's walk of a k tile over the group's G query heads and its q
//     tiles is long (G (L / 64 - t) steps for tile t, causal) while its
//     grid, one block per (k tile, KV head), is under a wave at GQA shapes
//     (B2 Hkv4 L1024: 128 blocks on 132 SMs). So the walk is cut into slabs
//     of per_slab steps, one block each (the wrapper's dkv_mma_split, a
//     function of the shape, the build and the SM count), whose fp32
//     partials the split sum adds in slab order and rounds to the input
//     dtype once (flash_bwd_split_sum_kernel<T>).
//   - D = 256, K2 (flash_bwd_dq_mma_256_kernel): one warpgroup would hold
//     dQ (128 fp32 a thread) beside S, dP and dS, past 255 registers. Two
//     warpgroups share the block, 256 threads, one block an SM, and split
//     dQ by columns, 64 fp32 a thread each. Warpgroup 0 holds Q and
//     warpgroup 1 dO in registers as the A operand of their 16 k-steps (64
//     registers: S = Q K^T and dP = dO V^T then read only K and V from
//     shared memory, half the bytes of reading both operands there); they
//     run side by side. Warpgroup 0 forms P and hands it in fp32 to
//     warpgroup 1 through 16 KB of shared memory (thread i writes, thread
//     i + 128 reads, behind named barrier 1), which forms dS = P (dP -
//     delta) scale as the one-warpgroup kernels do and hands it back
//     rounded to the input dtype, as dQ's A operand (barrier 2): dS is
//     theirs to the bit. Each warpgroup then makes dQ[:, 128 w..128 w +
//     127] += dS K[:, same], K read MN-major, in the one-warpgroup
//     kernel's order. 6 D operations a (q, k) pair, no recompute. Q and dO
//     arrive through the third stage of a three-stage K/V ring (192 KB,
//     loads two k tiles ahead), which they leave once in registers: 208 KB
//     of shared memory, 238 registers, no spill.
//   - D = 256, K3: it cannot hold dK and dV of its
//     64-row k tile in one warpgroup (256 fp32 a thread), and wgmma's M
//     edge of 64 rules out a 32-row k tile; so two warpgroups share the
//     block, one per output, each holding 128 fp32 a thread
//     (flash_bwd_dkv_mma_256_kernel, 256 threads, one block an SM).
//     Warpgroup 0 computes S^T = K Q^T and warpgroup 1 dP^T = V dO^T at
//     the same time, 64 keys x 64 queries in 16 k-steps each; warpgroup 0
//     forms P and hands it, in fp32, to warpgroup 1 through 16 KB of
//     shared memory (thread i writes, thread i + 128 reads, ordered by a
//     named barrier), so that dS = P (dP - delta) scale is the
//     one-warpgroup kernels' to the bit; then dV += P^T dO and dK += dS^T
//     Q run side by side. Per (q, k) pair that is 8 D operations, and Q and
//     dO are streamed once (64-row q tiles, two stages: 209 KB of shared
//     memory); one launch per output would compute S^T twice (10 D a
//     pair) and stream Q and dO twice. A k tile's walk is cut into slabs
//     as at D <= 32, aiming at one block's work per SM.
//   - Not yet: TMA loads (with multicast to the blocks that read one K/V
//     tile, which K2 at D = 256 reads from L2 for every 64 query rows), a
//     producer warp, and keeping a wgmma group in flight across the
//     softmax or across steps (ptxas serialized K2's products when its dQ
//     product ran on into the next step); each step waits for its products
//     before the next.
//
// Beyond the builds in bf16/fp16 (above 256): the general tensor-core
// kernels (flash_bwd_dq_general_mma_kernel, flash_bwd_dkv_general_mma_kernel,
// below; the wrappers zero-pad D to a multiple of 64), which stream Q, K, V
// and dO through shared memory 64 columns at a time and give the grid an
// axis over 256-column chunks of the output (K3 also one over its two
// outputs).
//
// fp32, at every D: register-tiled SIMT kernels (flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_general_kernel, below; D zero-padded to a multiple of 32,
// at least 64), a deliberate choice by dtype: TF32 tensor cores keep 10
// bits of mantissa, which the fp32 tolerance and the JAX package's fp32
// numerics do not allow. They cut long tiles into slabs across blocks where
// the grid does not fill the card and sum the slabs' fp32 partials in a
// second launch (flash_bwd_split_sum_kernel). Ragged L without padding:
// keys and queries at positions >= L are masked (P = 0, their lse is never
// read) and only rows < L are stored; the TPU path pads lse with a 1e30
// sentinel instead.
//
// Every launch is a 1-D grid, B * H included: no head count is too large.

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core kernels

constexpr int kMmaThreads = 128;  // one warpgroup; a warp owns 16 tile rows

// K3 streams q tiles of kDkvBq<D> rows (see the note at the top)
template <int D>
constexpr int kDkvBq = D <= 64 ? 64 : 32;

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // resident Q and dO tiles, two stages of K and V tiles (16-bit values)
  return 2 * (size_t)(2 * kTile * D + 2 * 2 * kTile * D);
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // resident K and V tiles, two stages of Q, dO, lse and delta
  return 2 * (size_t)(2 * kTile * D + 2 * 2 * kDkvBq<D> * D) +
         4 * (size_t)(2 * 2 * kDkvBq<D>);
}

// K3 at D = 256: two warpgroups, one per output, over q tiles of kDkv256Bq
// rows (see the note at the top)
constexpr int kDkv256Threads = 2 * kMmaThreads;
constexpr int kDkv256Bq = 64;

constexpr size_t dkv_mma_256_smem_bytes() {
  // D <= 128's layout at D = 256 and BQ = 64 (192 KB of tiles), then P
  // handed from one warpgroup to the other (BQ / 2 fp32 a thread)
  return 2 * (size_t)(2 * kTile * 256 + 2 * 2 * kDkv256Bq * 256) +
         4 * (size_t)(2 * 2 * kDkv256Bq) +
         4 * (size_t)(kMmaThreads * kDkv256Bq / 2);
}
static_assert(dkv_mma_256_smem_bytes() <= 232448, "fits an SM's 227 KB");

// K2 at D = 256: two warpgroups over a 64-row q tile, dQ split by columns
// (see the note at the top); named barriers 1 (P handed to warpgroup 1)
// and 2 (dS handed back), 0 being __syncthreads'
constexpr int kDq256Threads = 2 * kMmaThreads;
constexpr int kPBarrier = 1, kDsBarrier = 2;
constexpr int kDq256Stages = 3;  // k tiles in flight: loads two ahead

constexpr size_t dq_mma_256_smem_bytes() {
  // three stages of K and V tiles (192 KB; Q and dO pass through the last),
  // then P and dS handed between the warpgroups (kTile / 2 fp32 a thread)
  return 2 * (size_t)(kDq256Stages * 2 * kTile * 256) +
         4 * (size_t)(kMmaThreads * kTile / 2);
}
static_assert(dq_mma_256_smem_bytes() <= 232448, "fits an SM's 227 KB");

// K2's dS of one (64-row q tile, BK-key step), from the S and dP fragments
// (queries row_a and row_b as rows, keys k0.. as columns, in wgmma's
// accumulator layout; each row's lse, times log2 e, and delta in
// registers): dp becomes dS = P (dP - delta) scale with P = exp(scale s -
// lse), masked on steps that cross the diagonal or the end of the
// sequence.
template <int BK>
__device__ __forceinline__ bool dq_edge(int q0, int k0, int L, int causal) {
  return (causal && k0 + BK > q0) || k0 + BK > L;
}

// K2's P of element i of an S fragment (keys k0.. as columns, this
// thread's rows row_a and row_b, their lse times log2 e): exp2(scale log2(e)
// s - lse), 0 past L and above the diagonal on steps that cross either
// (edge)
__device__ __forceinline__ float dq_prob(float s, int i, float lse_a,
                                         float lse_b, bool edge, int k0,
                                         int row_a, int row_b, int t, int L,
                                         int causal, float scale_log2) {
  const bool hi = i & 2;
  float p = exp2f(s * scale_log2 - (hi ? lse_b : lse_a));
  if (edge) {
    const int k_pos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const int q_pos = hi ? row_b : row_a;
    if (k_pos >= L || (causal && k_pos > q_pos)) p = 0.f;
  }
  return p;
}

// dS = P (dP - delta) scale of element i (rows row_a, row_b as above)
__device__ __forceinline__ float dq_ds(float p, float dp, int i,
                                       float delta_a, float delta_b,
                                       float scale) {
  return p * (dp - ((i & 2) ? delta_b : delta_a)) * scale;
}

template <int BK>
__device__ __forceinline__ void dq_probs(const float (&s)[BK / 2],
                                         float (&dp)[BK / 2], float lse_a,
                                         float lse_b, float delta_a,
                                         float delta_b, int q0, int k0,
                                         int row_a, int row_b, int t, int L,
                                         int causal, float scale,
                                         float scale_log2) {
  const bool edge = dq_edge<BK>(q0, k0, L, causal);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    dp[i] = dq_ds(dq_prob(s[i], i, lse_a, lse_b, edge, k0, row_a, row_b, t,
                          L, causal, scale_log2),
                  dp[i], i, delta_a, delta_b, scale);
}

// K2: dQ for one 64-row q tile of one (batch, query head), D the build
// and ld <= D the caller's row length (see the note at the top)
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Hq, int Hkv, int L, int ld_arg, float scale,
                        int causal) {
  // dQ's columns a wgmma makes (its N), and the bytes of a tile's rows in
  // one column block (their swizzle)
  constexpr int kN = sm90::block_cols<D>(), kW = sm90::block_bytes<D>();
  // the rows' length: the caller's at the builds that read in place (D =
  // 16 and 32), D itself from 64, where a stride known at compile time
  // keeps those builds' registers (a runtime one took D = 64 from 128 to
  // 151, a fourth block an SM to three, and K2 at the training shape a
  // third slower, PERF.md)
  const int ld = D < 64 ? ld_arg : D;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // kTile x D, swizzled
  T* sDO = sQ + kTile * D;                 // kTile x D
  T* sK = sDO + kTile * D;                 // 2 stages x kTile x D
  T* sV = sK + 2 * kTile * D;              // 2 stages x kTile x D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + kTile - 1) / kTile;
  const int heads = gridDim.x / nq;  // B * Hq
  const int bh = blockIdx.x % heads;
  const int rank = blockIdx.x / heads;
  // causal: the last q tile walks every k tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const T* kb = k + (size_t)kvh * L * ld;
  const T* vb = v + (size_t)kvh * L * ld;

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sQ, q + (size_t)bh * L * ld, q0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sDO, dout + (size_t)bh * L * ld, q0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sK, kb, 0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sV, vb, 0, L, ld);
  sm90::cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lse_bh = lse + (size_t)bh * L;
  const float* delta_bh = delta + (size_t)bh * L;
  // a row past L takes no part: it is never stored
  const float lse_a = row_a < L ? lse_bh[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < L ? lse_bh[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < L ? delta_bh[row_a] : 0.f;
  const float delta_b = row_b < L ? delta_bh[row_b] : 0.f;
  const float scale_log2 = scale * kLog2e;

  const uint32_t q_smem = sm90::smem_addr(sQ);
  const uint32_t do_smem = sm90::smem_addr(sDO);

  float acc_dq[D / kN][kN / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc_dq[c][i] = 0.f;

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
    sm90::cp_async_wait<1>();  // this stage (and Q, dO) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int k0 = it * kTile;
    const uint32_t k_smem = sm90::smem_addr(sK + stage * kTile * D);
    const uint32_t v_smem = sm90::smem_addr(sV + stage * kTile * D);

    // S = Q K^T and dP = dO V^T, 64 rows x 64 keys in D / 16 k-steps, K
    // and V read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile, kW>(q_smem, kk),
                               sm90::desc_k_major<kTile, kW>(k_smem, kk),
                               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(dp, sm90::desc_k_major<kTile, kW>(do_smem, kk),
                               sm90::desc_k_major<kTile, kW>(v_smem, kk),
                               kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);

    dq_probs<kTile>(s, dp, lse_a, lse_b, delta_a, delta_b, q0, k0, row_a,
                    row_b, t, L, causal, scale, scale_log2);

    // dQ += dS K, dS rounded to the input dtype from registers; K read
    // MN-major ([key][d], the reduction runs over keys), one n = kN wgmma
    // per k16 step and column block
    uint32_t ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ads[kk], dp + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / kN; ++c)
        sm90::wgmma_rs_mn<T>(acc_dq[c], ads[kk],
                             sm90::desc_mn_major<kTile, kW>(k_smem, 16 * kk,
                                                            c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kN; ++c) sm90::fence_operands(acc_dq[c]);
    __syncthreads();  // done with this stage before it is refilled
  }

  // the caller's ld columns, at its row stride
  T* out = dq + (size_t)bh * L * ld;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kN * c + 8 * j + 2 * t;
      if (col >= ld) continue;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * ld + col) =
            sm90::pack2<T>(acc_dq[c][4 * j], acc_dq[c][4 * j + 1]);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * ld + col) =
            sm90::pack2<T>(acc_dq[c][4 * j + 2], acc_dq[c][4 * j + 3]);
    }
}

// K2 at D = 256: dQ of one 64-row q tile of one (batch, query head) in one
// pass by two warpgroups (see the note at the top). Warpgroup 0 holds Q and
// warpgroup 1 dO as wgmma A operands in registers; per k tile warpgroup 0
// computes S = Q K^T and forms P while warpgroup 1 computes dP = dO V^T,
// takes P through shared memory, forms dS and hands it back rounded; then
// each makes its half of dQ's columns, dQ[:, 128 w .. 128 w + 127] += dS
// K[:, same], in 64 fp32 a thread.
template <typename T>
__global__ void __launch_bounds__(kDq256Threads, 1)
flash_bwd_dq_mma_256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Hq, int Hkv, int L, int,
                            float scale, int causal) {
  constexpr int D = 256, kN = sm90::block_cols<D>();
  constexpr int kHalf = D / kN / 2;  // column blocks of a warpgroup's dQ
  constexpr int kStage = 2 * kTile * D;  // a stage: a K tile, a V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // kDq256Stages stages of a K and a V tile (kTile x D, swizzled); Q and
  // dO arrive in the last before they move to registers
  T* sKV = reinterpret_cast<T*>(smem_raw);
  // P from warpgroup 0 to 1 (thread i's kTile / 2 values as kTile / 8
  // float4s, the j-th at j * kMmaThreads + i), then dS back, rounded (its
  // A operand, a uint4 a k16 step, at the same places)
  float4* sX = reinterpret_cast<float4*>(sKV + kDq256Stages * kStage);

  // 0: S and P; 1: dP and dS (each warp's warpgroup, known to the compiler
  // as the same across the warp)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / kMmaThreads, 0);
  const int tid = threadIdx.x % kMmaThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + kTile - 1) / kTile;
  const int heads = gridDim.x / nq;  // B * Hq
  const int bh = blockIdx.x % heads;
  const int rank = blockIdx.x / heads;
  // causal: the last q tile walks every k tile, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;
  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int n_k = (k_end + kTile - 1) / kTile;

  // k tile `it` into its stage, as one cp.async group (empty past the last)
  auto load_kv = [&](int it) {
    if (it < n_k) {
      T* stage = sKV + it % kDq256Stages * kStage;
      sm90::load_tile_async<T, D, kTile, kDq256Threads>(stage, kb,
                                                        it * kTile, L);
      sm90::load_tile_async<T, D, kTile, kDq256Threads>(
          stage + kTile * D, vb, it * kTile, L);
    }
    sm90::cp_async_commit();
  };
  // Q and dO into the last stage, with the first k tile; then the second
  T* const sQ = sKV + (kDq256Stages - 1) * kStage;
  sm90::load_tile_async<T, D, kTile, kDq256Threads>(
      sQ, q + (size_t)bh * L * D, q0, L);
  sm90::load_tile_async<T, D, kTile, kDq256Threads>(
      sQ + kTile * D, dout + (size_t)bh * L * D, q0, L);
  load_kv(0);
  load_kv(1);

  // this thread's two rows of its warp's 16: g and g + 8; a row past L
  // takes no part: it is never stored
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lse_bh = lse + (size_t)bh * L;
  const float* delta_bh = delta + (size_t)bh * L;
  const float lse_a = row_a < L ? lse_bh[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < L ? lse_bh[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < L ? delta_bh[row_a] : 0.f;
  const float delta_b = row_b < L ? delta_bh[row_b] : 0.f;
  const float scale_log2 = scale * kLog2e;

  // the first product's A, Q (0) or dO (1), as 16 k16 steps in registers
  uint32_t a_first[D / 16][4];
  sm90::cp_async_wait<1>();  // Q, dO and the first k tile have landed
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::tile_to_a<kTile>(a_first[kk], sQ + wg * kTile * D, warp * 16 + g,
                           t, kk);

  float acc[kHalf][kN / 2];  // dQ's columns 128 wg ..
  float s[32];               // S, then P (0); dP, then dS (1)
#pragma unroll
  for (int c = 0; c < kHalf; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    // for every thread: k tile it has landed (k tile it + 1 may be in
    // flight), and both warpgroups are done with the stage of k tile it -
    // 1 (at it = 0: Q and dO), which takes k tile it + 2, and with the
    // hand-off buffer
    sm90::cp_async_wait<1>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_kv(it + 2);

    const int k0 = it * kTile;
    const T* stage = sKV + it % kDq256Stages * kStage;
    const uint32_t k_smem = sm90::smem_addr(stage);
    // the first product's B: K (0) or V (1)
    const uint32_t b_smem = k_smem + wg * kTile * D * (uint32_t)sizeof(T);

    // S = Q K^T (0) or dP = dO V^T (1), 64 rows x 64 keys in 16 k-steps,
    // A from registers, K and V read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_rs<T>(s, a_first[kk], sm90::desc_k_major<kTile>(b_smem, kk),
                        kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    // dS rounded to the input dtype, dQ's A operand
    uint32_t ads[kTile / 16][4];
    const bool edge = dq_edge<kTile>(q0, k0, L, causal);
    uint4* const sXa = reinterpret_cast<uint4*>(sX);
    if (wg == 0) {
      // P, in fp32 to warpgroup 1; dS back, rounded (the one-warpgroup
      // kernel's to the bit)
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = dq_prob(s[4 * j + e], 4 * j + e, lse_a, lse_b, edge,
                                 k0, row_a, row_b, t, L, causal, scale_log2);
        sX[j * kMmaThreads + tid] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      }
      sm90::named_barrier_arrive(kPBarrier, kDq256Threads);
      sm90::named_barrier_sync(kDsBarrier, kDq256Threads);  // dS has landed
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint4 a = sXa[kk * kMmaThreads + tid];
        ads[kk][0] = a.x;
        ads[kk][1] = a.y;
        ads[kk][2] = a.z;
        ads[kk][3] = a.w;
      }
    } else {
      sm90::named_barrier_sync(kPBarrier, kDq256Threads);  // P has landed
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float4 p = sX[j * kMmaThreads + tid];
        float* ds = s + 4 * j;
        ds[0] = dq_ds(p.x, ds[0], 4 * j, delta_a, delta_b, scale);
        ds[1] = dq_ds(p.y, ds[1], 4 * j + 1, delta_a, delta_b, scale);
        ds[2] = dq_ds(p.z, ds[2], 4 * j + 2, delta_a, delta_b, scale);
        ds[3] = dq_ds(p.w, ds[3], 4 * j + 3, delta_a, delta_b, scale);
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        sm90::acc_to_a<T>(ads[kk], s + 8 * kk);
        sXa[kk * kMmaThreads + tid] =
            make_uint4(ads[kk][0], ads[kk][1], ads[kk][2], ads[kk][3]);
      }
      sm90::named_barrier_arrive(kDsBarrier, kDq256Threads);
    }

    // dQ[:, this half] += dS K[:, this half]; K read MN-major, one n = 64
    // wgmma per k16 step and column block, in the one-warpgroup kernel's
    // order
#pragma unroll
    for (int c = 0; c < kHalf; ++c) sm90::fence_operands(acc[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kHalf; ++c)
        sm90::wgmma_rs_mn<T>(
            acc[c], ads[kk],
            sm90::desc_mn_major<kTile>(k_smem, 16 * kk, kHalf * wg + c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kHalf; ++c) sm90::fence_operands(acc[c]);
  }

  T* out = dq + (size_t)bh * L * D;
#pragma unroll
  for (int c = 0; c < kHalf; ++c)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kN * (kHalf * wg + c) + 8 * j + 2 * t;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
            sm90::pack2<T>(acc[c][4 * j], acc[c][4 * j + 1]);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
            sm90::pack2<T>(acc[c][4 * j + 2], acc[c][4 * j + 3]);
    }
}

// K3's P of one S^T element (key k_pos, query q_pos; the query's lse):
// exp(scale s - lse), 0 past L and above the diagonal on tiles that cross
// either (edge)
__device__ __forceinline__ float dkv_prob(float s, float lse, bool edge,
                                          int q_pos, int k_pos, int L,
                                          int causal, float scale_log2) {
  const float p = exp2f(s * scale_log2 - lse * kLog2e);
  return edge && (q_pos >= L || (causal && q_pos < k_pos)) ? 0.f : p;
}

// whether a (64-row k tile, BQ-row q tile) crosses the causal diagonal or
// the end of the sequence: only those tiles are masked
template <int BQ>
__device__ __forceinline__ bool dkv_edge(int q0, int k0, int L, int causal) {
  return (causal && q0 < k0 + kTile) || q0 + BQ > L;
}

// K3's P^T and dS^T of one (64-row k tile, BQ-row q tile), from the S^T and
// dP^T fragments (keys key_a and key_b as rows, queries q0.. as columns, in
// wgmma's accumulator layout; lse and delta per column, from shared
// memory): s becomes P = exp(scale s - lse) and dp becomes dS = P (dP -
// delta) scale, masked on tiles that cross the diagonal or the end of the
// sequence.
template <int BQ>
__device__ __forceinline__ void dkv_probs(float (&s)[BQ / 2],
                                          float (&dp)[BQ / 2],
                                          const float* tLse,
                                          const float* tDelta, int q0, int k0,
                                          int key_a, int key_b, int t, int L,
                                          int causal, float scale,
                                          float scale_log2) {
  const bool edge = dkv_edge<BQ>(q0, k0, L, causal);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(tLse + col);
    const float2 dl = *reinterpret_cast<const float2*>(tDelta + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const bool odd = e & 1;
      const float p = dkv_prob(s[i], odd ? ls.y : ls.x, edge,
                               q0 + col + odd, e >= 2 ? key_b : key_a, L,
                               causal, scale_log2);
      dp[i] = p * (dp[i] - (odd ? dl.y : dl.x)) * scale;
      s[i] = p;
    }
  }
}

// the caller's ld columns of one output of a k tile (acc in wgmma's
// accumulator layout, keys key_a and key_b as rows) at its row stride:
// rounded into out, or (split) this slab's fp32 partial, output `which` of
// (slabs, 2, B * Hkv, L, ld) with dV at 0 and dK at 1
template <typename T, int D, int kN>
__device__ __forceinline__ void dkv_store(const float (&acc)[D / kN][kN / 2],
                                          T* out, float* part, int which,
                                          int bkv, int heads, int slab,
                                          int slabs, int key_a, int key_b,
                                          int t, int L, int ld) {
  const size_t head_at = (size_t)bkv * L * ld;
  const size_t per_out = (size_t)heads * L * ld;
  float* const to = slabs > 1
      ? part + ((size_t)slab * 2 + which) * per_out + head_at
      : nullptr;
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = kN * c + 8 * j + 2 * t;
      if (col >= ld) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows key_a, then key_b
        const int key = h ? key_b : key_a;
        if (key >= L) continue;
        const size_t at = (size_t)key * ld + col;
        const int e = 4 * j + 2 * h;
        if (slabs > 1)
          *reinterpret_cast<float2*>(to + at) =
              make_float2(acc[c][e], acc[c][e + 1]);
        else
          *reinterpret_cast<uint32_t*>(out + head_at + at) =
              sm90::pack2<T>(acc[c][e], acc[c][e + 1]);
      }
    }
}

// K3 at D <= 128: dK and dV for one 64-row k tile of one (batch, KV head),
// summed over the G query heads of its group, or over one slab of that walk
// (see the note at the top)
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ part,
                         int Hq, int Hkv, int L, int ld, float scale,
                         int causal, int per_slab, int slabs) {
  constexpr int BQ = kDkvBq<D>;
  // dK's and dV's columns a wgmma makes (its N), and the bytes of a tile's
  // rows in one column block (their swizzle)
  constexpr int kN = sm90::block_cols<D>(), kW = sm90::block_bytes<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // kTile x D, swizzled
  T* sV = sK + kTile * D;                  // kTile x D
  T* sQ = sV + kTile * D;                  // 2 stages x BQ x D
  T* sDO = sQ + 2 * BQ * D;                // 2 stages x BQ x D
  float* sLse = reinterpret_cast<float*>(sDO + 2 * BQ * D);  // 2 x BQ
  float* sDelta = sLse + 2 * BQ;                              // 2 x BQ

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (L + kTile - 1) / kTile;
  const int heads = gridDim.x / (nk * slabs);  // B * Hkv
  const int bkv = blockIdx.x % heads;
  const int slab = blockIdx.x / heads % slabs;
  // causal: the first k tile is seen by every q tile, so it goes first
  const int k0 = (blockIdx.x / (heads * slabs)) * kTile;
  const int b = bkv / Hkv;
  const int G = Hq / Hkv;
  const int bh0 = b * Hq + (bkv - b * Hkv) * G;  // the group's first q head

  const int nq = (L + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  const int per = nq - q_first;  // q tiles per query head of the group
  // member-major, as the TPU kernel's grid; this block's slab of the walk
  const int it0 = slab * per_slab;
  const int it_end = min(G * per, it0 + per_slab);
  if (it0 >= it_end) return;  // the tile has fewer slabs than the longest

  auto load_q = [&](int it, int stage) {
    const int bh = bh0 + it / per;
    const int q0 = (q_first + it % per) * BQ;
    sm90::load_tile_async<T, D, BQ, kMmaThreads>(
        sQ + stage * BQ * D, q + (size_t)bh * L * ld, q0, L, ld);
    sm90::load_tile_async<T, D, BQ, kMmaThreads>(
        sDO + stage * BQ * D, dout + (size_t)bh * L * ld, q0, L, ld);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x, gq = q0 + i;
      const size_t at = (size_t)bh * L + (gq < L ? gq : 0);
      sm90::cp_async_4(sLse + stage * BQ + i, lse + at, gq < L ? 4 : 0);
      sm90::cp_async_4(sDelta + stage * BQ + i, delta + at, gq < L ? 4 : 0);
    }
  };

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sK, k + (size_t)bkv * L * ld, k0, L, ld);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sV, v + (size_t)bkv * L * ld, k0, L, ld);
  load_q(it0, 0);
  sm90::cp_async_commit();

  // this thread's two key rows of the warp's 16: g and g + 8
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_smem = sm90::smem_addr(sK);
  const uint32_t v_smem = sm90::smem_addr(sV);

  float acc_dk[D / kN][kN / 2], acc_dv[D / kN][kN / 2];
  float s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc_dk[c][i] = acc_dv[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

  for (int it = it0; it < it_end; ++it) {
    const int stage = (it - it0) & 1;
    if (it + 1 < it_end) load_q(it + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this stage (and K, V) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int q0 = (q_first + it % per) * BQ;
    const uint32_t q_smem = sm90::smem_addr(sQ + stage * BQ * D);
    const uint32_t do_smem = sm90::smem_addr(sDO + stage * BQ * D);
    const float* tLse = sLse + stage * BQ;
    const float* tDelta = sDelta + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x BQ queries in D / 16
    // k-steps, Q and dO read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, BQ>(s, sm90::desc_k_major<kTile, kW>(k_smem, kk),
                            sm90::desc_k_major<BQ, kW>(q_smem, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, BQ>(dp, sm90::desc_k_major<kTile, kW>(v_smem, kk),
                            sm90::desc_k_major<BQ, kW>(do_smem, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);

    dkv_probs<BQ>(s, dp, tLse, tDelta, q0, k0, key_a, key_b, t, L, causal,
                  scale, scale_log2);

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to the input dtype
    // from registers; dO and Q read MN-major ([query][d], the reduction
    // runs over query rows), one n = kN wgmma per k16 step and block
    uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::acc_to_a<T>(ap[kk], s + 8 * kk);
      sm90::acc_to_a<T>(ads[kk], dp + 8 * kk);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / kN; ++c) {
        sm90::wgmma_rs_mn<T>(
            acc_dv[c], ap[kk],
            sm90::desc_mn_major<BQ, kW>(do_smem, 16 * kk, c));
        sm90::wgmma_rs_mn<T>(
            acc_dk[c], ads[kk],
            sm90::desc_mn_major<BQ, kW>(q_smem, 16 * kk, c));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kN; ++c) {
      sm90::fence_operands(acc_dv[c]);
      sm90::fence_operands(acc_dk[c]);
    }
    __syncthreads();  // done with this stage before it is refilled
  }

  dkv_store<T, D, kN>(acc_dv, dv, part, 0, bkv, heads, slab, slabs, key_a,
                      key_b, t, L, ld);
  dkv_store<T, D, kN>(acc_dk, dk, part, 1, bkv, heads, slab, slabs, key_a,
                      key_b, t, L, ld);
}

// K3 at D = 256: dK and dV of one 64-row k tile of one (batch, KV head),
// summed over the group's query heads or one slab of that walk, in one
// pass by two warpgroups (see the note at the top): warpgroup 0 computes
// S^T = K Q^T, forms P, hands it to warpgroup 1 through shared memory and
// makes dV += P^T dO; warpgroup 1 computes dP^T = V dO^T meanwhile, forms
// dS from P and makes dK += dS^T Q. Each holds its output in 128 fp32 a
// thread, and both read the same q tile of Q and dO from the ring.
template <typename T>
__global__ void __launch_bounds__(kDkv256Threads, 1)
flash_bwd_dkv_mma_256_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ part, int Hq, int Hkv, int L,
                             int ld, float scale, int causal, int per_slab,
                             int slabs) {
  constexpr int D = 256, BQ = kDkv256Bq, kN = sm90::block_cols<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // kTile x D, swizzled
  T* sV = sK + kTile * D;                  // kTile x D
  T* sQ = sV + kTile * D;                  // 2 stages x BQ x D
  T* sDO = sQ + 2 * BQ * D;                // 2 stages x BQ x D
  float* sLse = reinterpret_cast<float*>(sDO + 2 * BQ * D);  // 2 x BQ
  float* sDelta = sLse + 2 * BQ;                              // 2 x BQ
  // P handed from warpgroup 0 to 1: thread i's BQ / 2 values as BQ / 8
  // float4s, the j-th at j * kMmaThreads + i
  float4* sP = reinterpret_cast<float4*>(sDelta + 2 * BQ);

  // 0: S^T, P and dV; 1: dP^T, dS and dK
  const int wg = threadIdx.x / kMmaThreads, tid = threadIdx.x % kMmaThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (L + kTile - 1) / kTile;
  const int heads = gridDim.x / (nk * slabs);  // B * Hkv
  const int bkv = blockIdx.x % heads;
  const int slab = blockIdx.x / heads % slabs;
  // causal: the first k tile is seen by every q tile, so it goes first
  const int k0 = (blockIdx.x / (heads * slabs)) * kTile;
  const int b = bkv / Hkv;
  const int G = Hq / Hkv;
  const int bh0 = b * Hq + (bkv - b * Hkv) * G;  // the group's first q head

  const int nq = (L + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  const int per = nq - q_first;  // q tiles per query head of the group
  // member-major, as the TPU kernel's grid; this block's slab of the walk
  const int it0 = slab * per_slab;
  const int it_end = min(G * per, it0 + per_slab);
  if (it0 >= it_end) return;  // the tile has fewer slabs than the longest

  auto load_q = [&](int it, int stage) {
    const int bh = bh0 + it / per;
    const int q0 = (q_first + it % per) * BQ;
    sm90::load_tile_async<T, D, BQ, kDkv256Threads>(
        sQ + stage * BQ * D, q + (size_t)bh * L * ld, q0, L, ld);
    sm90::load_tile_async<T, D, BQ, kDkv256Threads>(
        sDO + stage * BQ * D, dout + (size_t)bh * L * ld, q0, L, ld);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x, gq = q0 + i;
      const size_t at = (size_t)bh * L + (gq < L ? gq : 0);
      sm90::cp_async_4(sLse + stage * BQ + i, lse + at, gq < L ? 4 : 0);
      sm90::cp_async_4(sDelta + stage * BQ + i, delta + at, gq < L ? 4 : 0);
    }
  };

  sm90::load_tile_async<T, D, kTile, kDkv256Threads>(
      sK, k + (size_t)bkv * L * ld, k0, L, ld);
  sm90::load_tile_async<T, D, kTile, kDkv256Threads>(
      sV, v + (size_t)bkv * L * ld, k0, L, ld);
  load_q(it0, 0);
  sm90::cp_async_commit();

  // this thread's two key rows of its warp's 16: g and g + 8
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float scale_log2 = scale * kLog2e;
  // the first product's A (K, or V) and B (Q, or dO) and the output's B
  // (dO for dV, Q for dK): one code path for both warpgroups
  const uint32_t kv_smem = sm90::smem_addr(wg ? sV : sK);
  T* const sFirst = wg ? sDO : sQ;
  T* const sSecond = wg ? sQ : sDO;

  float acc[D / kN][kN / 2];  // dV (warpgroup 0) or dK (1)
  float s[BQ / 2];            // S^T, then P (0); dP^T, then dS (1)
#pragma unroll
  for (int c = 0; c < D / kN; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = 0.f;

  for (int it = it0; it < it_end; ++it) {
    const int stage = (it - it0) & 1;
    if (it + 1 < it_end) load_q(it + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this stage (and K, V) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int q0 = (q_first + it % per) * BQ;
    const uint32_t first_smem = sm90::smem_addr(sFirst + stage * BQ * D);
    const uint32_t second_smem = sm90::smem_addr(sSecond + stage * BQ * D);
    const float* tLse = sLse + stage * BQ;
    const float* tDelta = sDelta + stage * BQ;

    // S^T = K Q^T (0) or dP^T = V dO^T (1), 64 keys x BQ queries in 16
    // k-steps, Q and dO read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, BQ>(s, sm90::desc_k_major<kTile>(kv_smem, kk),
                            sm90::desc_k_major<BQ>(first_smem, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    const bool edge = dkv_edge<BQ>(q0, k0, L, causal);
    if (wg == 0) {
      // P, in fp32 to warpgroup 1 (its dS is then the one-warpgroup
      // kernels' to the bit), and rounded below for dV
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(tLse + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          s[4 * j + e] = dkv_prob(s[4 * j + e], odd ? ls.y : ls.x, edge,
                                  q0 + col + odd, e >= 2 ? key_b : key_a, L,
                                  causal, scale_log2);
        }
        sP[j * kMmaThreads + tid] = make_float4(s[4 * j], s[4 * j + 1],
                                                s[4 * j + 2], s[4 * j + 3]);
      }
      sm90::named_barrier_arrive(1, kDkv256Threads);
    } else {
      sm90::named_barrier_sync(1, kDkv256Threads);  // P has landed
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(tDelta + 8 * j + 2 * t);
        const float4 p = sP[j * kMmaThreads + tid];
        float* dp = s + 4 * j;
        dp[0] = p.x * (dp[0] - dl.x) * scale;
        dp[1] = p.y * (dp[1] - dl.y) * scale;
        dp[2] = p.z * (dp[2] - dl.x) * scale;
        dp[3] = p.w * (dp[3] - dl.y) * scale;
      }
    }

    // dV += P^T dO (0) or dK += dS^T Q (1), P or dS rounded to the input
    // dtype from registers; dO and Q read MN-major, one n = 64 wgmma per
    // k16 step and column block
    uint32_t a[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) sm90::acc_to_a<T>(a[kk], s + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / kN; ++c)
        sm90::wgmma_rs_mn<T>(acc[c], a[kk],
                             sm90::desc_mn_major<BQ>(second_smem, 16 * kk,
                                                     c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / kN; ++c) sm90::fence_operands(acc[c]);
    // done with this stage and with P before either is refilled
    __syncthreads();
  }

  if (wg == 0)
    dkv_store<T, D, kN>(acc, dv, part, 0, bkv, heads, slab, slabs, key_a,
                        key_b, t, L, ld);
  else
    dkv_store<T, D, kN>(acc, dk, part, 1, bkv, heads, slab, slabs, key_a,
                        key_b, t, L, ld);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 beyond the builds: the dK/dV tensor-core kernel
// (flash_bwd_dkv_general_mma_kernel), for any D that is a multiple of 64
// (the wrapper zero-pads to one, as it pads to the builds)
//
// One pass makes dV and another dK, each holding 128 fp32 of one output a
// thread. At D = 512 the resident K and V tiles alone (128 KB) and dK's or
// dV's 512 columns (256 fp32 a thread) do not fit. So:
//   - The grid is (64-row k tile, pass, 256-column chunk of the output,
//     b * Hkv) in one launch, tile-major with the first (longest causal)
//     k tiles first: the dV pass makes dV[:, c0:c0 + 256] and the dK pass
//     dK[:, c0:c0 + 256] of one k tile, each in 128 fp32 registers a
//     thread, over the G query heads of the group and their 32-row q tiles
//     (kGenBq, as K3 at D = 128).
//   - S^T = K Q^T (and in the dK pass dP^T = V dO^T) reduce over the full D
//     on wgmma (m64n32k16, every operand K-major), one 64-column block of
//     K, Q (V, dO) at a time through a ring of kRing stages filled by
//     cp.async with the runtime row stride D. Every q tile is nb = D / 64
//     such steps and one more, which forms P^T and dS^T (dkv_probs, as the
//     tuned kernel) and does dV[:, chunk] += P^T dO[:, chunk] or
//     dK[:, chunk] += dS^T Q[:, chunk], with dO's or Q's chunk (and the q
//     tile's lse and delta) loaded for that step and read MN-major. One
//     cp.async group per step, started kAhead steps ahead; 88 KB of shared
//     memory at any D.
//   - Work: per chunk, S^T twice (once in each pass) and dP^T once, and each
//     output once: 6 D ceil(D / 256) + 4 D operations a (q, k) pair, 16 D at
//     D = 512 against the ideal 8 D. Bound at B2 Hq16 Hkv4 L1024 D512
//     causal: 8 D a pair is 68.8 GFLOP, 0.0696 ms at 989 TFLOP/s.
//   - Each output column is written once, by one block, summed in a fixed
//     order: no atomics, the same bits on every run.

constexpr int kMmaChunk = 256;  // output columns a block accumulates
constexpr int kBlock = 64;      // columns of a streamed block
constexpr int kGenBq = 32;      // q rows of a step
constexpr int kAhead = 2;       // steps a load is started ahead of its use
constexpr int kRing = kAhead + 1;  // stages of the K/V/Q/dO block ring
// one ring stage: a K and a V block (kTile x 64), a Q and a dO block
// (kGenBq x 64)
constexpr int kGenStage = 2 * kTile * kBlock + 2 * kGenBq * kBlock;

constexpr size_t dkv_general_mma_smem_bytes() {
  // the ring, dO's or Q's chunk (16-bit values), one q tile's lse and delta
  return 2 * (size_t)(kRing * kGenStage + kGenBq * kMmaChunk) +
         4 * (size_t)(2 * kGenBq);
}

// one block of the kernel below; kDkPass picks the output (dK, else dV), so
// that each pass's wgmma sequence compiles without a branch inside it
template <typename T, bool kDkPass>
__device__ __forceinline__ void dkv_general_mma_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ out_all, int Hq, int Hkv, int L, int D, float scale,
    int causal) {
  constexpr int BQ = kGenBq;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // kRing stages, each a K, a V, a Q and a dO block (swizzled)
  T* sRing = reinterpret_cast<T*>(smem_raw);
  T* sC = sRing + kRing * kGenStage;  // dO's (dV pass) or Q's (dK) chunk
  float* sLse = reinterpret_cast<float*>(sC + BQ * kMmaChunk);  // BQ
  float* sDelta = sLse + BQ;                                    // BQ

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (L + kTile - 1) / kTile;
  const int nb = D / kBlock;  // the blocks S^T and dP^T reduce over
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / (nk * 2 * chunks);  // B * Hkv
  const int bkv = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads % chunks;
  // causal: the first k tile is seen by every q tile, so it goes first
  const int k0 = blockIdx.x / (heads * chunks * 2) * kTile;
  const int c0 = chunk * kMmaChunk;
  const int nc = min(kMmaChunk, D - c0) / kBlock;  // this chunk's blocks
  const int b = bkv / Hkv;
  const int G = Hq / Hkv;
  const int bh0 = b * Hq + (bkv - b * Hkv) * G;  // the group's first q head
  const T* kb = k + (size_t)bkv * L * D;
  const T* vb = v + (size_t)bkv * L * D;

  // q tiles: member-major, as the TPU kernel's grid; per q tile, nb steps
  // accumulate S^T (and dP^T) and one makes P^T, dS^T and the product
  const int nq = (L + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  const int per_head = nq - q_first;
  const int per = nb + 1;
  const int n_steps = G * per_head * per;

  // one step's loads as one cp.async group (empty past the last step). A
  // ring stage is refilled kRing block steps after its last use; the chunk,
  // lse and delta at least one step after the product that read them
  // (nb >= kAhead)
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      const int bh = bh0 + it / per_head;
      const int q0 = (q_first + it % per_head) * BQ;
      if (blk < nb) {
        T* stage = sRing + (it * nb + blk) % kRing * kGenStage;
        const int col = kBlock * blk;
        sm90::load_block_async<T, kTile, kMmaThreads>(stage, kb, k0, L, D,
                                                      col);
        sm90::load_block_async<T, BQ, kMmaThreads>(
            stage + 2 * kTile * kBlock, q + (size_t)bh * L * D, q0, L, D,
            col);
        if constexpr (kDkPass) {
          sm90::load_block_async<T, kTile, kMmaThreads>(
              stage + kTile * kBlock, vb, k0, L, D, col);
          sm90::load_block_async<T, BQ, kMmaThreads>(
              stage + 2 * kTile * kBlock + BQ * kBlock,
              dout + (size_t)bh * L * D, q0, L, D, col);
        }
      } else {
        const T* src = (kDkPass ? q : dout) + (size_t)bh * L * D;
        for (int c = 0; c < nc; ++c)
          sm90::load_block_async<T, BQ, kMmaThreads>(
              sC + c * BQ * kBlock, src, q0, L, D, c0 + kBlock * c);
        if (threadIdx.x < BQ) {
          const int i = threadIdx.x, gq = q0 + i;
          const size_t at = (size_t)bh * L + (gq < L ? gq : 0);
          sm90::cp_async_4(sLse + i, lse + at, gq < L ? 4 : 0);
          sm90::cp_async_4(sDelta + i, delta + at, gq < L ? 4 : 0);
        }
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kAhead; ++step) load_step(step);

  // this thread's two key rows of the warp's 16: g and g + 8
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t c_smem = sm90::smem_addr(sC);

  float acc[kMmaChunk / kBlock][32], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kAhead - 1>();  // this step's group has landed
    sm90::fence_proxy_async();
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kAhead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S^T (+)= K Q^T and, in the dK pass, dP^T (+)= V dO^T over this
      // block's 64 columns
      const uint32_t k_smem =
          sm90::smem_addr(sRing + (it * nb + blk) % kRing * kGenStage);
      const uint32_t v_smem = k_smem + kTile * kBlock * (uint32_t)sizeof(T);
      const uint32_t q_smem = v_smem + kTile * kBlock * (uint32_t)sizeof(T);
      const uint32_t do_smem = q_smem + BQ * kBlock * (uint32_t)sizeof(T);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        sm90::wgmma_ss<T, BQ>(s, sm90::desc_k_major<kTile>(k_smem, kk),
                              sm90::desc_k_major<BQ>(q_smem, kk),
                              blk > 0 || kk > 0);
      if constexpr (kDkPass) {
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk)
          sm90::wgmma_ss<T, BQ>(dp, sm90::desc_k_major<kTile>(v_smem, kk),
                                sm90::desc_k_major<BQ>(do_smem, kk),
                                blk > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      continue;
    }

    const int q0 = (q_first + it % per_head) * BQ;
    dkv_probs<BQ>(s, dp, sLse, sDelta, q0, k0, key_a, key_b, t, L, causal,
                  scale, scale_log2);
    // dV[:, chunk] += P^T dO[:, chunk] or dK[:, chunk] += dS^T Q[:, chunk],
    // P or dS rounded to the input dtype from registers; the chunk read
    // MN-major ([query][d], the reduction runs over query rows)
    uint32_t a[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      if constexpr (kDkPass)
        sm90::acc_to_a<T>(a[kk], dp + 8 * kk);
      else
        sm90::acc_to_a<T>(a[kk], s + 8 * kk);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kMmaChunk / kBlock; ++c)
        if (c < nc)
          sm90::wgmma_rs_mn<T>(acc[c], a[kk],
                               sm90::desc_mn_major<BQ>(c_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c)
      sm90::fence_operands(acc[c]);
  }

  T* out = out_all + (size_t)bkv * L * D;
#pragma unroll
  for (int c = 0; c < kMmaChunk / kBlock; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + kBlock * c + 8 * j + 2 * t;
      if (key_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)key_a * D + col) =
            sm90::pack2<T>(acc[c][4 * j], acc[c][4 * j + 1]);
      if (key_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)key_b * D + col) =
            sm90::pack2<T>(acc[c][4 * j + 2], acc[c][4 * j + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_general_mma_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 int Hq, int Hkv, int L, int D, float scale,
                                 int causal) {
  // the pass: blocks [heads * chunks, 2 heads * chunks) of each k tile
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / ((L + kTile - 1) / kTile * 2 * chunks);
  if (blockIdx.x / (heads * chunks) % 2)
    dkv_general_mma_block<T, true>(q, k, v, dout, lse, delta, dk, Hq, Hkv,
                                   L, D, scale, causal);
  else
    dkv_general_mma_block<T, false>(q, k, v, dout, lse, delta, dv, Hq, Hkv,
                                    L, D, scale, causal);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 beyond the builds: the dQ tensor-core kernel
// (flash_bwd_dq_general_mma_kernel), for any D that is a multiple of 64
// and at least 128 (the wrapper zero-pads to one)
//
// K3g's design with queries and keys trading roles. The tuned K2 keeps Q,
// dO and dQ of its 64-row q tile in shared memory and registers, which at
// D = 512 would take 128 KB and 256 fp32 a thread. So:
//   - The grid is (64-row q tile, 256-column chunk of dQ, b * Hq) in one
//     launch, tile-major with the last (longest causal) q tiles first; a
//     block holds dQ[:, c0:c0 + 256] of its q tile in 128 fp32 registers a
//     thread and walks the keys up to the diagonal in 32-key steps
//     (kGenBk).
//   - S = Q K^T and dP = dO V^T reduce over the full D on wgmma
//     (m64n32k16, every operand K-major), one 64-column block of Q, dO, K
//     and V at a time through K3g's ring (kRing stages filled by cp.async
//     with the runtime row stride D). Every k step is nb = D / 64 such
//     steps and one more, which forms dS (dq_probs, as the tuned kernel;
//     each row's lse and delta stay in registers) and does dQ[:, chunk] +=
//     dS K[:, chunk], dS rounded to the input dtype as _dq_kernel casts it,
//     with K's chunk loaded for that step and read MN-major. One cp.async
//     group per step, started kAhead steps ahead; 88 KB of shared memory
//     at any D, so two blocks share an SM.
//   - Work: per chunk S and dP once, and dQ once: 4 D ceil(D / 256) + 2 D
//     operations a (q, k) pair, 10 D at D = 512 against the ideal 6 D.
//     Bound at B2 Hq16 Hkv4 L1024 D512 causal: 6 D a pair is 51.6 GFLOP,
//     0.0522 ms at 989 TFLOP/s.
//   - Each dQ column is written once, by one block, summed in a fixed
//     order: no atomics, the same bits on every run.

constexpr int kGenBk = 32;  // keys of a K2g step
static_assert(kGenBk == kGenBq, "K2g's ring stages are K3g's");

constexpr size_t dq_general_mma_smem_bytes() {
  // the ring (a Q and a dO block of kTile rows, a K and a V block of kGenBk
  // rows: kGenStage, as K3g's) and K's chunk (16-bit values)
  return 2 * (size_t)(kRing * kGenStage + kGenBk * kMmaChunk);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_general_mma_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dq, int Hq, int Hkv, int L,
                                int D, float scale, int causal) {
  constexpr int BK = kGenBk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // kRing stages, each a Q, a dO, a K and a V block (swizzled)
  T* sRing = reinterpret_cast<T*>(smem_raw);
  T* sC = sRing + kRing * kGenStage;  // K's chunk: BK rows x 256 columns

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (L + kTile - 1) / kTile;
  const int nb = D / kBlock;  // the blocks S and dP reduce over
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / (nq * chunks);  // B * Hq
  const int bh = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads % chunks;
  const int rank = blockIdx.x / (heads * chunks);
  // causal: the last q tile walks every k step, so it goes first
  const int q0 = (causal ? nq - 1 - rank : rank) * kTile;
  const int c0 = chunk * kMmaChunk;
  const int nc = min(kMmaChunk, D - c0) / kBlock;  // this chunk's blocks
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const T* qb = q + (size_t)bh * L * D;
  const T* dob = dout + (size_t)bh * L * D;
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;

  // k steps up to the q tile's diagonal; per k step, nb steps accumulate S
  // and dP and one makes dS and the product
  const int k_end = causal ? min(L, q0 + kTile) : L;
  const int per = nb + 1;
  const int n_steps = (k_end + BK - 1) / BK * per;

  // one step's loads as one cp.async group (empty past the last step). A
  // ring stage is refilled kRing block steps after its last use; the chunk
  // at least one step after the product that read it (nb >= kAhead)
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      const int k0 = it * BK;
      if (blk < nb) {
        T* stage = sRing + (it * nb + blk) % kRing * kGenStage;
        const int col = kBlock * blk;
        sm90::load_block_async<T, kTile, kMmaThreads>(stage, qb, q0, L, D,
                                                      col);
        sm90::load_block_async<T, kTile, kMmaThreads>(
            stage + kTile * kBlock, dob, q0, L, D, col);
        sm90::load_block_async<T, BK, kMmaThreads>(
            stage + 2 * kTile * kBlock, kb, k0, L, D, col);
        sm90::load_block_async<T, BK, kMmaThreads>(
            stage + 2 * kTile * kBlock + BK * kBlock, vb, k0, L, D, col);
      } else {
        for (int c = 0; c < nc; ++c)
          sm90::load_block_async<T, BK, kMmaThreads>(
              sC + c * BK * kBlock, kb, k0, L, D, c0 + kBlock * c);
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kAhead; ++step) load_step(step);

  // this thread's two rows of the warp's 16: g and g + 8; a row past L
  // takes no part (it is never stored)
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lse_bh = lse + (size_t)bh * L;
  const float* delta_bh = delta + (size_t)bh * L;
  const float lse_a = row_a < L ? lse_bh[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < L ? lse_bh[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < L ? delta_bh[row_a] : 0.f;
  const float delta_b = row_b < L ? delta_bh[row_b] : 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t c_smem = sm90::smem_addr(sC);

  float acc[kMmaChunk / kBlock][32], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kAhead - 1>();  // this step's group has landed
    sm90::fence_proxy_async();
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kAhead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S (+)= Q K^T and dP (+)= dO V^T over this block's 64 columns
      const uint32_t q_smem =
          sm90::smem_addr(sRing + (it * nb + blk) % kRing * kGenStage);
      const uint32_t do_smem = q_smem + kTile * kBlock * (uint32_t)sizeof(T);
      const uint32_t k_smem = do_smem + kTile * kBlock * (uint32_t)sizeof(T);
      const uint32_t v_smem = k_smem + BK * kBlock * (uint32_t)sizeof(T);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        sm90::wgmma_ss<T, BK>(s, sm90::desc_k_major<kTile>(q_smem, kk),
                              sm90::desc_k_major<BK>(k_smem, kk),
                              blk > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        sm90::wgmma_ss<T, BK>(dp, sm90::desc_k_major<kTile>(do_smem, kk),
                              sm90::desc_k_major<BK>(v_smem, kk),
                              blk > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      continue;
    }

    dq_probs<BK>(s, dp, lse_a, lse_b, delta_a, delta_b, q0, it * BK, row_a,
                 row_b, t, L, causal, scale, scale_log2);
    // dQ[:, chunk] += dS K[:, chunk], dS rounded to the input dtype from
    // registers; K's chunk read MN-major ([key][d], the reduction runs over
    // keys)
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::acc_to_a<T>(a[kk], dp + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kMmaChunk / kBlock; ++c)
        if (c < nc)
          sm90::wgmma_rs_mn<T>(acc[c], a[kk],
                               sm90::desc_mn_major<BK>(c_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kMmaChunk / kBlock; ++c)
      sm90::fence_operands(acc[c]);
  }

  T* out = dq + (size_t)bh * L * D;
#pragma unroll
  for (int c = 0; c < kMmaChunk / kBlock; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + kBlock * c + 8 * j + 2 * t;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
            sm90::pack2<T>(acc[c][4 * j], acc[c][4 * j + 1]);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
            sm90::pack2<T>(acc[c][4 * j + 2], acc[c][4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: K3 (flash_bwd_dkv_general_kernel), register-tiled SIMT, for any D
// that is a multiple of 32 and at least 64 (the wrapper zero-pads to one)
//
// Full fp32 FMAs, as the twin computes: single-pass TF32 keeps about three
// decimal digits and would break the fp32 limit of 1e-4 x max|ref|
// (3xTF32 on wgmma is the later route to measure against this one).
//   - Passes and chunks as K3g in bf16: the grid has an axis over the two
//     outputs (dV: S^T alone, then P^T dO; dK: S^T and dP^T, then dS^T Q)
//     and one over 256-column chunks of the output; a block of 256 threads
//     holds dV[:, chunk] or dK[:, chunk] of its 64-row k tile, 64 fp32 a
//     thread. Work: 4 D + 2 * 256 (dV) and 2 D + 2 D + 2 * 256 (dK)
//     operations a (q, k) pair per chunk, 10 D at D = 256 against the
//     ideal 8 D.
//   - Register tiles: for S^T (64 keys x 64 queries of a q step) and dP^T
//     each thread owns a 4 x 4 outer-product tile, reading four keys' and
//     four queries' values with 16-byte shared loads, each load feeding 16
//     FMAs; for the product it owns 8 keys x 8 columns (64 FMAs for four
//     16-byte loads a query). A warp's threads are laid out 4 x 8 over
//     each tile, so that one 16-byte load of a warp reads 128 bytes at most
//     (one shared-memory wavefront). P^T or dS^T goes through shared
//     memory ([query][key]) between the two. Warps whose columns lie past
//     D (D <= 192, or the last chunk) skip the product; at D <= 64 the
//     product tiles are 8 keys x 4 columns of a 128-column chunk
//     (kNarrowD), so that four warps, not two, share it.
//   - Copies: K, Q (and V, dO in the dK pass) stream in 32-column blocks
//     through a ring of kF32Ring stages filled by 16-byte cp.async, one
//     group a step started kF32Ahead steps ahead, so the next blocks'
//     loads overlap this block's FMAs; each staged row is padded to 36
//     floats, so that the 16-byte loads of 8 consecutive rows fall in
//     distinct banks. The product's dO or Q chunk (64 rows x 256 columns)
//     arrives in quarters with the last four block steps of its q step,
//     lse and delta with the product step. 190 KB of shared memory: one
//     block an SM.
//   - Load balance: with few KV heads (B Hkv = 4 at B2 Hq8 Hkv2) a block
//     per (k tile, output, chunk, KV head) cannot fill 132 SMs, and causal
//     k tiles differ 16-fold in work. So the q steps of one k tile (the G
//     query heads of its group, member-major, times its q tiles) are cut
//     into slabs of per_slab steps (the wrapper's dkv_split); a block per
//     slab writes an fp32 partial into a scratch tensor, and a second
//     launch (flash_bwd_split_sum_kernel) sums each row's slabs in
//     slab order: no atomics, the same bits on every run. Where one slab
//     covers every k tile the block writes dK or dV itself. The grid is
//     tile-major with the first (longest causal) k tile first; a slab past
//     its tile's steps exits at once.
//   - Bound at B2 Hq8 Hkv2 L1024 D256 causal: 8 D a pair is 17.2 GFLOP,
//     0.257 ms at SIMT's 67 TFLOP/s; the 10 D executed take 0.321 ms there.
//     What holds it: an SM moves 32 floats a cycle from shared memory to
//     registers for 128 FMA lanes, so the 4 x 4 tiles (2 FMAs a float)
//     run at about half the FMA rate and the 8 x 8 product (4 a float) at
//     about two thirds (PERF.md).

using simt::kF32Ahead;
using simt::kF32Block;
using simt::kF32Ring;
using simt::kF32Row;
using simt::kF32Threads;
using simt::load_f32_block;
constexpr int kF32PRow = kTile + 4;     // floats of a row of P^T or dS^T
// one ring stage: a K, a Q, a V and a dO block (kTile rows each)
constexpr int kF32Stage = 4 * kTile * kF32Row;
static_assert(simt::kF32Rows == kTile, "a staged block is one k or q tile");

constexpr size_t dkv_general_smem_bytes() {
  // the ring, dO's or Q's chunk, P^T or dS^T, one q tile's lse and delta
  return sizeof(float) * (size_t)(kF32Ring * kF32Stage + kTile * kMmaChunk +
                                  kTile * kF32PRow + 2 * kTile);
}

// at D <= kNarrowD the fp32 K2's and K3's product tiles cover a 128-column
// chunk, 8 x 4 a thread, so that twice as many warps hold columns of the
// output: at D = 64 K2 ran 14% and K3 11% faster so, at D = 128 K3 3.5%
// slower (PERF.md)
constexpr int kNarrowD = 64;

// S^T's 4 x 4 tile of a thread (simt::f32_tile_product): keys 16 (w % 4) +
// (lane % 4) + 4 i and queries 32 (w / 4) + lane / 4 + 8 j of warp w, so
// that one 16-byte load of a warp reads 4 key rows or 8 query rows, 128
// bytes at most
constexpr int kKeyStep = 4, kQueryStep = 8;

// one block of the kernel below; kDkPass picks the output (dK, else dV),
// kNarrow a product tile of 8 keys x 4 columns on a 128-column chunk
// (D <= kNarrowD), else 8 x 8 on 256
template <bool kDkPass, bool kNarrow>
__device__ __forceinline__ void dkv_general_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ out_all, float* __restrict__ part, int Hq, int Hkv,
    int L, int D, float scale, int causal, int per_slab, int slabs) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sRing = reinterpret_cast<float*>(smem_raw);
  float* sC = sRing + kF32Ring * kF32Stage;  // dO's (dV pass) or Q's chunk
  float* sP = sC + kTile * kMmaChunk;     // P^T or dS^T, [query][key]
  float* sLse = sP + kTile * kF32PRow;    // kTile
  float* sDelta = sLse + kTile;           // kTile

  const int tid = threadIdx.x;
  const int nk = (L + kTile - 1) / kTile;
  const int nb = D / kF32Block;  // the blocks S^T and dP^T reduce over
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / (nk * slabs * 2 * chunks);  // B * Hkv
  const int bkv = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads % chunks;
  const int slab = blockIdx.x / (heads * chunks * 2) % slabs;
  // causal: the first k tile is seen by every q tile, so it goes first
  const int k0 = blockIdx.x / (heads * chunks * 2 * slabs) * kTile;
  const int G = Hq / Hkv;
  // the k tile's q steps: member-major over the group's query heads, then
  // the q tiles from the diagonal on (causal); this slab's share of them
  const int q_first = causal ? k0 / kTile : 0;
  const int per_head = nk - q_first;
  const int it0 = slab * per_slab;
  if (it0 >= G * per_head) return;  // the tile needs fewer slabs
  const int n_it = min(per_slab, G * per_head - it0);
  const int per = nb + 1;  // nb block steps and the product step
  const int n_steps = n_it * per;
  const int c0 = chunk * kMmaChunk;
  const int b = bkv / Hkv;
  const int bh0 = b * Hq + (bkv - b * Hkv) * G;  // the group's first q head
  const float* kb = k + (size_t)bkv * L * D;
  const float* vb = v + (size_t)bkv * L * D;

  // one step's loads as one cp.async group (empty past the last step). A
  // ring stage is refilled kF32Ring block steps after its last use; the chunk
  // quarters go with block steps max(kF32Ahead, nb - 3 + m), and lse and delta
  // with the product step, so all are started no earlier than the first
  // step of their q step, after the last product read the previous ones
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      const int gi = it0 + it;
      const int bh = bh0 + gi / per_head;
      const int q0 = (q_first + gi % per_head) * kTile;
      if (blk < nb) {
        float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
        const int col = kF32Block * blk;
        load_f32_block(stage, kb, k0, L, D, col);
        load_f32_block(stage + kTile * kF32Row, q + (size_t)bh * L * D, q0,
                       L, D, col);
        if constexpr (kDkPass) {
          load_f32_block(stage + 2 * kTile * kF32Row, vb, k0, L, D, col);
          load_f32_block(stage + 3 * kTile * kF32Row,
                         dout + (size_t)bh * L * D, q0, L, D, col);
        }
      }
      const float* src = (kDkPass ? q : dout) + (size_t)bh * L * D;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (blk != max(kF32Ahead, nb - 3 + m)) continue;
        // rows [16 m, 16 m + 16) of the chunk, 64 16-byte pieces a row;
        // columns past D are zero
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = tid + j * kF32Threads;
          const int r = 16 * m + (i >> 6), col = c0 + 4 * (i & 63);
          const bool ok = q0 + r < L && col < D;
          sm90::cp_async_16(sC + r * kMmaChunk + 4 * (i & 63),
                            src + (ok ? (size_t)(q0 + r) * D + col : 0),
                            ok ? 16 : 0);
        }
      }
      if (blk == nb && tid < kTile) {
        const int gq = q0 + tid;
        const size_t at = (size_t)bh * L + (gq < L ? gq : 0);
        sm90::cp_async_4(sLse + tid, lse + at, gq < L ? 4 : 0);
        sm90::cp_async_4(sDelta + tid, delta + at, gq < L ? 4 : 0);
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kF32Ahead; ++step) load_step(step);

  const int warp = tid >> 5, lane = tid & 31;
  // S^T tile: the first key and query (f32_tile_product)
  const int tk = 16 * (warp & 3) + (lane & 3);
  const int tq = 32 * (warp >> 2) + (lane >> 2);
  // product tile: keys pk .. pk + 7, columns pc .. pc + 3 (and pc + 32 ..
  // pc + 35 on a 256-column chunk), so that one 16-byte load of a warp
  // reads 4 P^T or 8 chunk pieces of one row, 128 bytes at most
  constexpr int kCols = kNarrow ? 4 : 8;   // columns a thread holds
  constexpr int kPairCols = 8 * kCols;     // chunk columns of a warp pair
  const int pk = 32 * (warp & 1) + 8 * (lane & 3);
  const int pc = kPairCols * (warp >> 1) + 4 * (lane >> 2);
  const bool has_cols = c0 + kPairCols * (warp >> 1) < D;
  float acc[8][kCols], s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kF32Ahead - 1>();  // this step's group has landed
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kF32Ahead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S^T (+)= K Q^T and, in the dK pass, dP^T (+)= V dO^T over this
      // block's 32 columns
      const float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
      if (blk == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      }
      simt::f32_tile_product<kKeyStep, kQueryStep>(
          s, stage + tk * kF32Row, stage + (kTile + tq) * kF32Row);
      if constexpr (kDkPass)
        simt::f32_tile_product<kKeyStep, kQueryStep>(
            dp, stage + (2 * kTile + tk) * kF32Row,
            stage + (3 * kTile + tq) * kF32Row);
      continue;
    }

    // P^T (dV pass) or dS^T = P^T (dP^T - delta) scale (dK pass) into
    // shared memory, P = exp(scale s - lse) masked past L and above the
    // diagonal
    const int gi = it0 + it;
    const int q0 = (q_first + gi % per_head) * kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = tq + kQueryStep * j;
      const int q_pos = q0 + ql;
      const float row_lse = sLse[ql];
      const float row_delta = sDelta[ql];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = tk + kKeyStep * i;
        const bool ok = q_pos < L && (!causal || q_pos >= k0 + key);
        const float p = ok ? expf(s[i][j] * scale - row_lse) : 0.f;
        sP[ql * kF32PRow + key] =
            kDkPass ? p * (dp[i][j] - row_delta) * scale : p;
      }
    }
    __syncthreads();

    // dV[:, chunk] += P^T dO[:, chunk] or dK[:, chunk] += dS^T Q[:, chunk]
    if (has_cols)
      simt::f32_rows_product<kCols>(acc, sP + pk, kF32PRow, sC + pc,
                                    kMmaChunk);
  }

  // rows pk .. pk + 7 of the k tile, columns c0 + pc (and c0 + pc + 32):
  // into dK or dV, or into this slab's partial
  float* out = slabs == 1
                   ? out_all + (size_t)bkv * L * D
                   : part + ((size_t)(slab * 2 + kDkPass) * heads + bkv) *
                                L * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = k0 + pk + r;
    if (row >= L) break;
#pragma unroll
    for (int h = 0; h < kCols / 4; ++h) {
      const int col = c0 + pc + 32 * h;
      if (col < D)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
  }
}

template <bool kNarrow>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_general_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ part, int Hq, int Hkv, int L,
                             int D, float scale, int causal, int per_slab,
                             int slabs) {
  // the pass: blocks [heads * chunks, 2 heads * chunks) of each (k tile,
  // slab)
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
  const int heads = gridDim.x / ((L + kTile - 1) / kTile * slabs * 2 *
                                 chunks);
  if (blockIdx.x / (heads * chunks) % 2)
    dkv_general_block<true, kNarrow>(q, k, v, dout, lse, delta, dk, part, Hq,
                                     Hkv, L, D, scale, causal, per_slab,
                                     slabs);
  else
    dkv_general_block<false, kNarrow>(q, k, v, dout, lse, delta, dv, part,
                                      Hq, Hkv, L, D, scale, causal, per_slab,
                                      slabs);
}

// four sums, stored in the output's type (16-bit: rounded to nearest once)
__device__ __forceinline__ void store4(float* out, size_t e, float4 v) {
  reinterpret_cast<float4*>(out)[e] = v;
}

template <typename T>
__device__ __forceinline__ void store4(T* out, size_t e, float4 v) {
  reinterpret_cast<uint2*>(out)[e] =
      make_uint2(sm90::pack2<T>(v.x, v.y), sm90::pack2<T>(v.z, v.w));
}

// the second launch of a split K2 or K3: each row of each output the sum of
// its tile's slabs of the fp32 partials (slabs, outs, heads, L, D), in slab
// order (K3: outs 2, dV at 0 and dK at 1; K2: outs 1, dQ), stored in TOut
// (fp32 for the fp32 kernels; bf16 or fp16, rounded once, for the
// tensor-core K3 at D <= 32). A tile's slabs follow from its steps: K3's k
// tile t has G (nt - t) q steps when causal (its first tile the longest),
// K2's q tile t has t + 1 k tiles (last_longest, G = 1), and every tile G
// nt when not causal. Memory-bound: it reads every slab's partial once.
template <typename TOut>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_split_sum_kernel(const float4* __restrict__ part,
                           TOut* __restrict__ out0, TOut* __restrict__ out1,
                           int outs, int heads, int L, int D, int G,
                           int causal, int last_longest, int per_slab) {
  const size_t per_out = (size_t)heads * L * D / 4;  // float4s of an output
  const int nt = (L + kTile - 1) / kTile;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       i < outs * per_out; i += (size_t)gridDim.x * blockDim.x) {
    const int out = (int)(i / per_out);
    const size_t e = i - out * per_out;
    const int tile = (int)(e * 4 / D % L) / kTile;
    const int steps = G * (!causal ? nt : last_longest ? tile + 1 : nt - tile);
    const int n = (steps + per_slab - 1) / per_slab;
    const float4* src = part + out * per_out + e;
    float4 sum = src[0];
    for (int sl = 1; sl < n; ++sl) {
      const float4 x = src[(size_t)sl * outs * per_out];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    store4(out ? out1 : out0, e, sum);
  }
}

// ---------------------------------------------------------------------------
// fp32: K2 (flash_bwd_dq_f32_kernel), register-tiled SIMT, for any D that
// is a multiple of 32 and at least 64 (the wrapper zero-pads to one)
//
// Full fp32 FMAs, as the twin computes (no TF32: fp32's limit is 1e-4). It
// is the fp32 K3g's design above with queries and keys trading roles, on
// the fp32 K1's grid and tiles (flash_fwd.cu):
//   - A block of 256 threads owns one 64-row q tile of one b * Hq + h, one
//     256-column chunk of dQ (the last chunk narrower where D is not a
//     multiple of 256) and one slab of the tile's k tiles. The 1-D grid is
//     tile-major, the longest causal q tile (the last, which sees every k
//     tile) first.
//   - S = Q K^T and dP = dO V^T of each 64-key step: Q, K, dO and V stream
//     in 32-column blocks through the ring of simt.cuh (3 stages, loads two
//     steps ahead, rows padded to 36 floats). Each thread owns a 4 x 4 tile
//     of S and one of dP, queries 8 w + 4 (lane / 16) .. + 3 and keys
//     lane % 16 + 16 i of warp w (simt::f32_tile_product), as the fp32
//     K1's S; its four queries' lse and delta stay in registers.
//   - dS = P (dP - delta) scale, P = exp(scale S - lse) masked past L and
//     above the diagonal, goes through shared memory as dS^T ([key][query],
//     rows padded to 68 floats, one 16-byte store per key).
//   - dQ[:, chunk] += dS K[:, chunk]: each thread owns an 8 x 8 tile of the
//     block's 64 x 256 fp32 dQ chunk (64 registers), as the fp32 K1's O:
//     per key four 16-byte loads (8 dS, 8 K values) for 64 FMAs. K's chunk
//     (64 keys x 256 columns) arrives in quarters with the last block steps
//     of its k step. Warps whose columns lie past D skip the product; at
//     D <= 64 the tiles are 8 x 4 of a 128-column chunk (kNarrowD), as in
//     K3 above.
//   - Work: S and dP once per chunk, dS K once: 4 D ceil(D / 256) + 2 D
//     operations a (q, k) pair, the twin's 6 D at D <= 256.
//   - Load balance as the fp32 K1: where one block per (q tile, chunk,
//     head) cannot fill the card, a tile's k tiles are cut into slabs of
//     per_slab (the wrapper's dq_split, fwd_split's rule); each block of a
//     split grid writes an fp32 partial and flash_bwd_split_sum_kernel adds
//     each row's slabs in slab order: no atomics, the same bits on every
//     run. A slab past its tile's k tiles exits at once.
//   - Shared memory: ring 108 KB, K's chunk 64 KB, dS^T 17 KB: 189 KB, one
//     block an SM.
//   - Bound: 6 D operations a pair at SIMT's 67 TFLOP/s (B2 Hq8 Hkv2 L1024
//     D256 causal: 12.9 GFLOP, 0.193 ms). What holds it is K3g's limit: the
//     4 x 4 tiles feed 2 FMAs per float moved from shared memory, the 8 x 8
//     product 4, where an SM moves 32 floats a cycle to 128 FMA lanes
//     (PERF.md).

constexpr size_t dq_f32_smem_bytes() {
  // the ring, K's chunk, dS^T
  return sizeof(float) * (size_t)(kF32Ring * kF32Stage + kTile * kMmaChunk +
                                  kTile * kF32PRow);
}

template <bool kNarrow>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, float* __restrict__ part,
                        int Hq, int Hkv, int L, int D, float scale,
                        int causal, int per_slab, int slabs) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sRing = reinterpret_cast<float*>(smem_raw);
  float* sK = sRing + kF32Ring * kF32Stage;  // K's chunk, kTile x kMmaChunk
  float* sDS = sK + kTile * kMmaChunk;       // dS^T, [key][query]

  const int tid = threadIdx.x;
  const int nq = (L + kTile - 1) / kTile;
  const int nb = D / kF32Block;  // the blocks S and dP reduce over
  const int chunks = (D + kMmaChunk - 1) / kMmaChunk;
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
  const int per = nb + 1;  // nb block steps and the dS / product step
  const int n_steps = n_it * per;
  const int c0 = chunk * kMmaChunk;
  const int b = bh / Hq;
  const int kvh = b * Hkv + (bh - b * Hq) / (Hq / Hkv);
  const float* qb = q + (size_t)bh * L * D;
  const float* dob = dout + (size_t)bh * L * D;
  const float* kb = k + (size_t)kvh * L * D;
  const float* vb = v + (size_t)kvh * L * D;

  // one step's loads as one cp.async group (empty past the last step). A
  // ring stage is refilled kF32Ring block steps after its last use; K's
  // chunk quarters go with block steps max(kF32Ahead, nb - 3 + m), so all
  // are started no earlier than the first step of their k step, after the
  // last product read the previous chunk
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int it = step / per, blk = step - it * per;
      const int k0 = (it0 + it) * kTile;
      if (blk < nb) {
        float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
        const int col = kF32Block * blk;
        load_f32_block(stage, qb, q0, L, D, col);
        load_f32_block(stage + kTile * kF32Row, kb, k0, L, D, col);
        load_f32_block(stage + 2 * kTile * kF32Row, dob, q0, L, D, col);
        load_f32_block(stage + 3 * kTile * kF32Row, vb, k0, L, D, col);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (blk != max(kF32Ahead, nb - 3 + m)) continue;
        // keys [16 m, 16 m + 16) of the chunk, 64 16-byte pieces a row;
        // keys past L and columns past D are zero
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = tid + j * kF32Threads;
          const int r = 16 * m + (i >> 6), col = c0 + 4 * (i & 63);
          const bool ok = k0 + r < L && col < D;
          sm90::cp_async_16(sK + r * kMmaChunk + 4 * (i & 63),
                            kb + (ok ? (size_t)(k0 + r) * D + col : 0),
                            ok ? 16 : 0);
        }
      }
    }
    sm90::cp_async_commit();
  };
  for (int step = 0; step < kF32Ahead; ++step) load_step(step);

  const int warp = tid >> 5, lane = tid & 31;
  // S and dP tiles: queries tq .. tq + 3, keys tk + 16 i (f32_tile_product)
  const int tq = 8 * warp + 4 * (lane >> 4);
  const int tk = lane & 15;
  // product tile: queries pq .. pq + 7, columns pc .. pc + 3 (and pc + 32
  // .. pc + 35 on a 256-column chunk); warps past D have none
  constexpr int kCols = kNarrow ? 4 : 8;   // columns a thread holds
  constexpr int kPairCols = 8 * kCols;     // chunk columns of a warp pair
  const int pq = 32 * (warp & 1) + 8 * (lane & 3);
  const int pc = kPairCols * (warp >> 1) + 4 * (lane >> 2);
  const bool has_cols = c0 + kPairCols * (warp >> 1) < D;
  // a query past L takes no part: its dQ row is never stored
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = q0 + tq + j;
    row_lse[j] = row < L ? lse[(size_t)bh * L + row] : 0.f;
    row_delta[j] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  float acc[8][kCols], s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    sm90::cp_async_wait<kF32Ahead - 1>();  // this step's group has landed
    __syncthreads();  // for every thread; all are done with the last step
    load_step(step + kF32Ahead);
    const int it = step / per, blk = step - it * per;
    if (blk < nb) {
      // S (+)= Q K^T and dP (+)= dO V^T over this block's 32 columns
      const float* stage = sRing + (it * nb + blk) % kF32Ring * kF32Stage;
      if (blk == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      }
      simt::f32_tile_product<1, 16>(s, stage + tq * kF32Row,
                                    stage + (kTile + tk) * kF32Row);
      simt::f32_tile_product<1, 16>(dp, stage + (2 * kTile + tq) * kF32Row,
                                    stage + (3 * kTile + tk) * kF32Row);
      continue;
    }

    // dS^T = (P (dP - delta) scale)^T into shared memory, P = exp(scale s -
    // lse) masked where the k tile crosses the diagonal or the end of the
    // sequence
    const int k0 = (it0 + it) * kTile;
    const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > L;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(s[j][i] * scale - row_lse[j]);
        if (edge) {
          const int key = k0 + tk + 16 * i;
          if (key >= L || (causal && key > q0 + tq + j)) p = 0.f;
        }
        s[j][i] = p * (dp[j][i] - row_delta[j]) * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sDS + (tk + 16 * i) * kF32PRow + tq) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    __syncthreads();

    // dQ[:, chunk] += dS K[:, chunk]
    if (has_cols)
      simt::f32_rows_product<kCols>(acc, sDS + pq, kF32PRow, sK + pc,
                                    kMmaChunk);
  }
  if (!has_cols) return;

  // rows pq .. pq + 7 of the q tile, columns c0 + pc (and c0 + pc + 32):
  // into dQ, or into this slab's partial
  float* out = slabs == 1 ? dq + (size_t)bh * L * D
                          : part + ((size_t)slab * heads + bh) * L * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + pq + r;
    if (row >= L) break;
#pragma unroll
    for (int h = 0; h < kCols / 4; ++h) {
      const int col = c0 + pc + 32 * h;
      if (col < D)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq (K2) or dk, dv (K3)
  int B, Hq, Hkv, L;
  float scale;
  int causal;
  cudaStream_t stream;
  int ld = 0;  // the tuned K2 and K3: the caller's row length, at most D
  float* part = nullptr;  // the tuned K3's split: its slabs' partials
  int per_slab = 0, slabs = 1;
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// one block per (tile, head): tile-major, so the tile rank is the slow index
template <typename T, typename Kernel>
int launch_dq_kernel(Kernel kernel, size_t smem, int threads, const Args& a) {
  if (int err = prepare(kernel, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  kernel<<<(int)grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.Hq, a.Hkv, a.L, a.ld, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

// D = 256 on its two-warpgroup kernel
template <typename T, int D>
int launch_dq_mma(const Args& a) {
  if constexpr (D == 256)
    return launch_dq_kernel<T>(flash_bwd_dq_mma_256_kernel<T>,
                               dq_mma_256_smem_bytes(), kDq256Threads, a);
  else
    return launch_dq_kernel<T>(flash_bwd_dq_mma_kernel<T, D>,
                               dq_mma_smem_bytes<D>(), kMmaThreads, a);
}

// one block per (k tile, slab, KV head): tile-major, so the tile rank is
// the slow index
template <typename T, typename Kernel>
int launch_dkv_kernel(Kernel kernel, size_t smem, int threads,
                      const Args& a) {
  if (int err = prepare(kernel, smem)) return err;
  const long long grid =
      (long long)((a.L + kTile - 1) / kTile) * a.slabs * a.B * a.Hkv;
  if (grid > INT_MAX) return -1;
  kernel<<<(int)grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.part,
      a.Hq, a.Hkv, a.L, a.ld, a.scale, a.causal, a.per_slab, a.slabs);
  return (int)cudaGetLastError();
}

// D = 256 on its two-warpgroup kernel
template <typename T, int D>
int launch_dkv_mma(const Args& a) {
  if constexpr (D == 256)
    return launch_dkv_kernel<T>(flash_bwd_dkv_mma_256_kernel<T>,
                                dkv_mma_256_smem_bytes(), kDkv256Threads, a);
  else
    return launch_dkv_kernel<T>(flash_bwd_dkv_mma_kernel<T, D>,
                                dkv_mma_smem_bytes<D>(), kMmaThreads, a);
}

template <typename T>
int launch_mma(const Args& a, int D, bool dq) {
  if (dq) {
    switch (D) {
      case 16: return launch_dq_mma<T, 16>(a);
      case 32: return launch_dq_mma<T, 32>(a);
      case 64: return launch_dq_mma<T, 64>(a);
      case 128: return launch_dq_mma<T, 128>(a);
      case 256: return launch_dq_mma<T, 256>(a);
    }
    return -1;
  }
  switch (D) {
    case 16: return launch_dkv_mma<T, 16>(a);
    case 32: return launch_dkv_mma<T, 32>(a);
    case 64: return launch_dkv_mma<T, 64>(a);
    case 128: return launch_dkv_mma<T, 128>(a);
    case 256: return launch_dkv_mma<T, 256>(a);
  }
  return -1;
}

// dtype: 1 = float16, 2 = bfloat16 (tensor cores; K2's and K3's D in {16,
// 32, 64, 128, 256}); ld in 8..D, a multiple of 8
int dispatch(const Args& a, int D, int dtype, bool dq) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.L < 1 || a.ld < 8 ||
      a.ld > D || a.ld % 8 != 0)
    return -1;
  switch (dtype) {
    case 1:
      return launch_mma<__half>(a, D, dq);
    case 2:
      return launch_mma<__nv_bfloat16>(a, D, dq);
    default:
      return -1;
  }
}

// one block per (q tile, slab, chunk, head): tile-major, so the tile rank
// is the slow index
int launch_dq_f32(const Args& a, int D, float* part, int per_slab,
                  int slabs) {
  const auto kernel = D <= kNarrowD ? flash_bwd_dq_f32_kernel<true>
                                    : flash_bwd_dq_f32_kernel<false>;
  const size_t smem = dq_f32_smem_bytes();
  if (int err = prepare(kernel, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * slabs *
                         ((D + kMmaChunk - 1) / kMmaChunk) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  kernel<<<(int)grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0), part, a.Hq, a.Hkv, a.L, D,
      a.scale, a.causal, per_slab, slabs);
  return (int)cudaGetLastError();
}

// one block per (k tile, slab, pass, chunk, KV head): tile-major, so the
// tile rank is the slow index
int launch_dkv_general(const Args& a, int D, float* part, int per_slab,
                       int slabs) {
  const auto kernel = D <= kNarrowD ? flash_bwd_dkv_general_kernel<true>
                                    : flash_bwd_dkv_general_kernel<false>;
  const size_t smem = dkv_general_smem_bytes();
  if (int err = prepare(kernel, smem)) return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * slabs * 2 *
                         ((D + kMmaChunk - 1) / kMmaChunk) * a.B * a.Hkv;
  if (grid > INT_MAX) return -1;
  kernel<<<(int)grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), part, a.Hq, a.Hkv, a.L, D, a.scale,
      a.causal, per_slab, slabs);
  return (int)cudaGetLastError();
}

// the split sum over (slabs, outs, heads, L, D) partials (see its kernel),
// into outputs of dtype 0 (fp32), 1 (fp16) or 2 (bf16)
template <typename TOut>
int launch_split_sum_as(const void* part, void* out0, void* out1, int outs,
                        int heads, int L, int D, int G, int causal,
                        int last_longest, int per_slab, cudaStream_t stream) {
  const long long float4s = (long long)outs * heads * L * D / 4;
  const int grid = (int)std::min<long long>(
      (float4s + kF32Threads - 1) / kF32Threads, 16384);
  flash_bwd_split_sum_kernel<TOut><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float4*>(part), static_cast<TOut*>(out0),
      static_cast<TOut*>(out1), outs, heads, L, D, G, causal, last_longest,
      per_slab);
  return (int)cudaGetLastError();
}

int launch_split_sum(const void* part, void* out0, void* out1, int outs,
                     int heads, int L, int D, int G, int causal,
                     int last_longest, int per_slab, int dtype,
                     cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_split_sum_as<float>(part, out0, out1, outs, heads, L, D,
                                        G, causal, last_longest, per_slab,
                                        stream);
    case 1:
      return launch_split_sum_as<__half>(part, out0, out1, outs, heads, L, D,
                                         G, causal, last_longest, per_slab,
                                         stream);
    case 2:
      return launch_split_sum_as<__nv_bfloat16>(part, out0, out1, outs,
                                                heads, L, D, G, causal,
                                                last_longest, per_slab,
                                                stream);
    default:
      return -1;
  }
}

// one block per (tile, pass, chunk, head): tile-major, so the tile rank is
// the slow index (K3g: k tile and pass; K2g: q tile)
template <typename T>
int launch_dkv_general_mma(const Args& a, int D) {
  const size_t smem = dkv_general_mma_smem_bytes();
  if (int err = prepare(flash_bwd_dkv_general_mma_kernel<T>, smem))
    return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) * 2 *
                         ((D + kMmaChunk - 1) / kMmaChunk) * a.B * a.Hkv;
  if (grid > INT_MAX) return -1;
  flash_bwd_dkv_general_mma_kernel<T>
      <<<(int)grid, kMmaThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Hq,
          a.Hkv, a.L, D, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_general_mma(const Args& a, int D) {
  const size_t smem = dq_general_mma_smem_bytes();
  if (int err = prepare(flash_bwd_dq_general_mma_kernel<T>, smem))
    return err;
  const long long grid = (long long)((a.L + kTile - 1) / kTile) *
                         ((D + kMmaChunk - 1) / kMmaChunk) * a.B * a.Hq;
  if (grid > INT_MAX) return -1;
  flash_bwd_dq_general_mma_kernel<T>
      <<<(int)grid, kMmaThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.out0), a.Hq, a.Hkv, a.L, D, a.scale,
          a.causal);
  return (int)cudaGetLastError();
}

// the (B, Hq, Hkv, L, D) every general kernel takes; mma: D a multiple of
// 64 with at least kAhead blocks
bool general_shape_ok(int B, int Hq, int Hkv, int L, int D) {
  return B >= 1 && Hkv >= 1 && Hq % Hkv == 0 && L >= 1 && D >= 1;
}

bool mma_head_dim_ok(int D) { return D % kBlock == 0 && D / kBlock >= kAhead; }

}  // namespace

extern "C" {

// K2 on tensor cores in bf16 (dtype 2) or fp16 (1), D the build (16, 32,
// 64, 128 or 256) and ld the caller's row length: at D = 16 and 32 a
// multiple of 8 up to D (the build zero-fills columns ld..D - 1 in shared
// memory and stores ld columns), from 64 D itself. Returns 0 on success,
// the cudaError_t of a refused launch, or -1 for arguments the kernel does
// not take (the Python wrapper checks them first). lse and delta are (B, Hq, L) fp32; q, dout and dq are (B, Hq, L,
// ld); k and v are (B, Hkv, L, ld); all contiguous, and the (B, H, L, ld)
// tensors 16-byte aligned.
int metisfl_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int Hq, int Hkv, int L, int D,
                         int ld, int dtype, int causal, float scale,
                         void* stream) {
  if (D >= 64 && ld != D) return -1;  // those builds read rows of D
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, B, Hq, Hkv, L,
         scale, causal, static_cast<cudaStream_t>(stream)};
  a.ld = ld;
  return dispatch(a, D, dtype, true);
}

// K3. As K2, with dk and dv (B, Hkv, L, ld) as outputs. The split: each k
// tile's walk over (query head, q tile) is cut into slabs of per_slab
// steps (slabs for the longest tile). slabs = 1 writes dk and dv; slabs > 1
// writes fp32 partials into part, (slabs, 2, B * Hkv, L, ld) with dV at
// index 0 and dK at 1, which metisfl_flash_bwd_dkv_split_sum then sums.
int metisfl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, void* part,
                          int B, int Hq, int Hkv, int L, int D, int ld,
                          int dtype, int causal, int per_slab, int slabs,
                          float scale, void* stream) {
  if (per_slab < 1 || slabs < 1 || (slabs > 1 && part == nullptr))
    return -1;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, L,
         scale, causal, static_cast<cudaStream_t>(stream)};
  a.ld = ld;
  a.part = static_cast<float*>(part);
  a.per_slab = per_slab;
  a.slabs = slabs;
  return dispatch(a, D, dtype, false);
}

// K2 in fp32 (dtype 0), register-tiled, at any head dim D that is a
// multiple of 32 and at least 64 (the wrapper zero-pads to one), with K2's
// arguments and the split: each q tile's k tiles are cut into slabs of
// per_slab (slabs for the longest tile). slabs = 1 writes dq; slabs > 1
// writes fp32 partials into part, (slabs, B * Hq, L, D), which
// metisfl_flash_bwd_dq_split_sum then sums. The (B, H, L, D) tensors
// contiguous and 16-byte aligned.
int metisfl_flash_bwd_dq_general(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* part,
                                 int B, int Hq, int Hkv, int L, int D,
                                 int dtype, int causal, int per_slab,
                                 int slabs, float scale, void* stream) {
  if (!general_shape_ok(B, Hq, Hkv, L, D) || dtype != 0 ||
      D % kF32Block != 0 || D / kF32Block < kF32Ahead || per_slab < 1 ||
      slabs < 1 || (slabs > 1 && part == nullptr))
    return -1;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch_dq_f32(a, D, static_cast<float*>(part), per_slab, slabs);
}

// The second launch of a split fp32 K2: dq (B, Hq, L, D) from the partials
// of metisfl_flash_bwd_dq_general with the same shapes, causal and
// per_slab; D a multiple of 4, every tensor 16-byte aligned.
int metisfl_flash_bwd_dq_split_sum(const void* part, void* dq, int B, int Hq,
                                   int L, int D, int causal, int per_slab,
                                   void* stream) {
  if (B < 1 || Hq < 1 || L < 1 || D < 4 || D % 4 != 0 || per_slab < 1)
    return -1;
  return launch_split_sum(part, dq, nullptr, 1, B * Hq, L, D, 1, causal, 1,
                          per_slab, 0, static_cast<cudaStream_t>(stream));
}

// K3 in fp32 (dtype 0) at any head dim D that is a multiple of 32 and at
// least 64 (the wrapper zero-pads to one), with K3's arguments and the
// split: each k tile's q steps are cut into slabs of per_slab steps
// (slabs for the longest tile). slabs = 1 writes dk and dv; slabs > 1
// writes fp32 partials into part, (slabs, 2, B * Hkv, L, D) with dV at
// index 0 and dK at 1, which metisfl_flash_bwd_dkv_split_sum then sums.
// The (B, H, L, D) tensors contiguous and 16-byte aligned.
int metisfl_flash_bwd_dkv_general(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, void* part, int B,
                                  int Hq, int Hkv, int L, int D, int dtype,
                                  int causal, int per_slab, int slabs,
                                  float scale, void* stream) {
  if (!general_shape_ok(B, Hq, Hkv, L, D) || dtype != 0 ||
      D % kF32Block != 0 || D / kF32Block < kF32Ahead || per_slab < 1 ||
      slabs < 1 || (slabs > 1 && part == nullptr))
    return -1;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch_dkv_general(a, D, static_cast<float*>(part), per_slab,
                            slabs);
}

// The second launch of a split K3: dv and dk (B, Hkv, L, D) from the
// partials of metisfl_flash_bwd_dkv_general (dtype 0, fp32 outputs) or of
// a split metisfl_flash_bwd_dkv (dtype 1 fp16, 2 bf16, D its ld) with the
// same shapes, causal and per_slab; D a multiple of 4, every tensor 16-byte
// aligned.
int metisfl_flash_bwd_dkv_split_sum(const void* part, void* dk, void* dv,
                                    int B, int Hq, int Hkv, int L, int D,
                                    int causal, int per_slab, int dtype,
                                    void* stream) {
  if (!general_shape_ok(B, Hq, Hkv, L, D) || D % 4 != 0 || per_slab < 1)
    return -1;
  // outputs in the partials' order: dV at 0, dK at 1
  return launch_split_sum(part, dv, dk, 2, B * Hkv, L, D, Hq / Hkv, causal, 0,
                          per_slab, dtype, static_cast<cudaStream_t>(stream));
}

// K3 on tensor cores in bf16 (dtype 2) or fp16 (1) at any head dim D that
// is a multiple of 64 and at least 128 (the wrapper zero-pads to one), with
// K3's arguments: one launch makes dV and dK, one block per (64-row k
// tile, output, 256-column chunk, b * Hkv); the (B, H, L, D) tensors
// contiguous and 16-byte aligned.
int metisfl_flash_bwd_dkv_general_mma(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int Hq,
                                      int Hkv, int L, int D, int dtype,
                                      int causal, float scale,
                                      void* stream) {
  if (!general_shape_ok(B, Hq, Hkv, L, D) || !mma_head_dim_ok(D)) return -1;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch_dkv_general_mma<__half>(a, D);
    case 2: return launch_dkv_general_mma<__nv_bfloat16>(a, D);
    default: return -1;
  }
}

// K2 on tensor cores in bf16 (dtype 2) or fp16 (1) at any head dim D that
// is a multiple of 64 and at least 128 (the wrapper zero-pads to one), with
// K2's arguments: one block per (64-row q tile, 256-column chunk of dQ,
// b * Hq); the (B, H, L, D) tensors contiguous and 16-byte aligned.
int metisfl_flash_bwd_dq_general_mma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int Hq, int Hkv, int L,
                                     int D, int dtype, int causal,
                                     float scale, void* stream) {
  if (!general_shape_ok(B, Hq, Hkv, L, D) || !mma_head_dim_ok(D)) return -1;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1: return launch_dq_general_mma<__half>(a, D);
    case 2: return launch_dq_general_mma<__nv_bfloat16>(a, D);
    default: return -1;
  }
}

const char* metisfl_bwd_error_string(int err) {
  return err < 0 ? "invalid argument" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
