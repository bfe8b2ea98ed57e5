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
// bf16 and fp16: tensor-core kernels (flash_bwd_*_mma_kernel).
//   - Every product is wgmma.mma_async m64nNk16 with fp32 accumulation,
//     issued by one warpgroup of 4 warps for the block's 64-row tile (warp
//     w owns rows 16 w..16 w + 15). Both operands of QK^T and dO V^T come
//     from shared memory through matrix descriptors (sm90.cuh); P and dS
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
//   - Not yet: TMA loads, warp specialisation (a producer warp and two
//     consumer warpgroups) and keeping a wgmma group in flight across the
//     softmax; each step waits for its products before the next.
//
// fp32: the SIMT kernels (flash_bwd_*_simt_kernel), a deliberate choice by
// dtype: TF32 tensor cores keep 10 bits of mantissa, which the fp32
// tolerance and the JAX package's fp32 numerics do not allow.
//   - Blocks of 256 threads; four threads own one row of the block's 64-row
//     tile and split its 64 columns (and its D output columns) four ways.
//     Operands are staged in shared memory with rows padded to D + 1 floats.
//   - K2: one block per (64-row q tile, b * Hq + h). Q, dO, lse and delta
//     are loaded once; a loop walks the K/V tiles (up to the diagonal when
//     causal) and dQ stays in registers until one store.
//   - K3: one block per (64-row k tile, b * Hkv + h_kv). K and V are loaded
//     once; a loop walks the G query heads of the KV group and, within
//     each, the q tiles from the first that overlaps the k tile (causal) to
//     the last, with dK and dV in registers: no atomics.
//   - Ragged L without padding: keys and queries at positions >= L are
//     masked (P = 0, their lse is never read) and only rows < L are stored.
//     The TPU path pads lse with a 1e30 sentinel instead.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: SIMT kernels

constexpr int kThreads = 256;  // 4 threads per tile row
constexpr int kCols = kTile / 4;  // tile columns per thread

// rows [r0, r0 + kTile) of a (L, D) matrix into a tile with rows padded to
// D + 1 floats (the four lanes of a row and the eight rows of a warp then
// fall in distinct banks); rows >= L are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int g = r0 + r;
    dst[r * (D + 1) + d] = g < L ? src[(size_t)g * D + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_simt_smem_bytes() {
  // Q, dO, K, V tiles and the dS tile
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
constexpr size_t dkv_simt_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles, and one tile's lse and delta
  return sizeof(float) *
         (size_t)(4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

// K2 in fp32: dQ for one 64-row q tile of one (batch, query head).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Hq, int Hkv, int L,
                         float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                      // kTile x (D + 1)
  float* sDO = sQ + kTile * (D + 1);     // kTile x (D + 1)
  float* sK = sDO + kTile * (D + 1);     // kTile x (D + 1)
  float* sV = sK + kTile * (D + 1);      // kTile x (D + 1)
  float* sDS = sV + kTile * (D + 1);     // kTile x (kTile + 1)

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int q_pos = q0 + row;
  const bool row_in = q_pos < L;

  const float* kb = k + (size_t)kvh * L * D;
  const float* vb = v + (size_t)kvh * L * D;
  // a row past L takes no part: its P is 0 and its lse is never read
  const float row_lse = row_in ? lse[(size_t)bh * L + q_pos] : 0.f;
  const float row_delta = row_in ? delta[(size_t)bh * L + q_pos] : 0.f;

  load_tile<D>(sQ, q + (size_t)bh * L * D, q0, L);
  load_tile<D>(sDO, dout + (size_t)bh * L * D, q0, L);

  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous step is done with sK / sV
    load_tile<D>(sK, kb, k0, L);
    load_tile<D>(sV, vb, k0, L);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = sQ + row * (D + 1);
    const float* dorow = sDO + row * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float dod = dorow[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = (sub + 4 * j) * (D + 1) + d;
        s[j] = fmaf(qd, sK[c], s[j]);
        dp[j] = fmaf(dod, sV[c], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int k_pos = k0 + sub + 4 * j;
      const bool ok = row_in && k_pos < L && (!causal || q_pos >= k_pos);
      const float p = ok ? expf(s[j] * scale - row_lse) : 0.f;
      sDS[row * (kTile + 1) + sub + 4 * j] = p * (dp[j] - row_delta) * scale;
    }
    __syncwarp();  // a row's dS is written and read by the same four lanes

    const float* dsrow = sDS + row * (kTile + 1);
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float ds = dsrow[c];
      const float* krow = sK + c * (D + 1) + sub;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(ds, krow[4 * j], acc[j]);
    }
  }

  if (row_in) {
    float* out = dq + ((size_t)bh * L + q_pos) * D + sub;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) out[4 * j] = acc[j];
  }
}

// K3 in fp32: dK and dV for one 64-row k tile of one (batch, KV head),
// summed over the G query heads of its group.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Hq, int Hkv, int L, float scale, int causal) {
  extern __shared__ float smem[];
  float* sK = smem;                        // kTile x (D + 1)
  float* sV = sK + kTile * (D + 1);        // kTile x (D + 1)
  float* sQ = sV + kTile * (D + 1);        // kTile x (D + 1)
  float* sDO = sQ + kTile * (D + 1);       // kTile x (D + 1)
  float* sP = sDO + kTile * (D + 1);       // kTile x (kTile + 1), [key][query]
  float* sDS = sP + kTile * (kTile + 1);   // kTile x (kTile + 1), [key][query]
  float* sLse = sDS + kTile * (kTile + 1); // kTile
  float* sDelta = sLse + kTile;            // kTile

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row inside the tile
  const int sub = tid & 3;
  const int bkv = blockIdx.y;  // b * Hkv + h_kv
  const int b = bkv / Hkv;
  const int hkv = bkv - b * Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * kTile;
  const int k_pos = k0 + row;
  const bool row_in = k_pos < L;

  load_tile<D>(sK, k + (size_t)bkv * L * D, k0, L);
  load_tile<D>(sV, v + (size_t)bkv * L * D, k0, L);

  float acc_k[D / 4], acc_v[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc_k[j] = acc_v[j] = 0.f;

  // causal: q tiles before the k tile's first row see none of its keys
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + hkv * G + g;
    const float* qb = q + (size_t)bh * L * D;
    const float* dob = dout + (size_t)bh * L * D;
    const float* lseb = lse + (size_t)bh * L;
    const float* deltab = delta + (size_t)bh * L;
    for (int q0 = q_begin; q0 < L; q0 += kTile) {
      __syncthreads();  // the previous step is done with sQ / sDO / stats
      load_tile<D>(sQ, qb, q0, L);
      load_tile<D>(sDO, dob, q0, L);
      if (tid < kTile) {
        const int gq = q0 + tid;
        sLse[tid] = gq < L ? lseb[gq] : 0.f;
        sDelta[tid] = gq < L ? deltab[gq] : 0.f;
      }
      __syncthreads();

      float s[kCols], dp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
      const float* krow = sK + row * (D + 1);
      const float* vrow = sV + row * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
        const float vd = vrow[d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = (sub + 4 * j) * (D + 1) + d;
          s[j] = fmaf(kd, sQ[c], s[j]);
          dp[j] = fmaf(vd, sDO[c], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = sub + 4 * j;
        const int q_pos = q0 + c;
        const bool ok = row_in && q_pos < L && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(s[j] * scale - sLse[c]) : 0.f;
        sP[row * (kTile + 1) + c] = p;
        sDS[row * (kTile + 1) + c] = p * (dp[j] - sDelta[c]) * scale;
      }
      __syncwarp();  // a key row's P and dS are written and read by its lanes

      const float* prow = sP + row * (kTile + 1);
      const float* dsrow = sDS + row * (kTile + 1);
#pragma unroll 2
      for (int c = 0; c < kTile; ++c) {
        const float p = prow[c];
        const float ds = dsrow[c];
        const float* dorow = sDO + c * (D + 1) + sub;
        const float* qrow = sQ + c * (D + 1) + sub;
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
          acc_v[j] = fmaf(p, dorow[4 * j], acc_v[j]);
          acc_k[j] = fmaf(ds, qrow[4 * j], acc_k[j]);
        }
      }
    }
  }

  if (row_in) {
    const size_t at = ((size_t)bkv * L + k_pos) * D + sub;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      dk[at + 4 * j] = acc_k[j];
      dv[at + 4 * j] = acc_v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core kernels

constexpr int kMmaThreads = 128;  // one warpgroup; a warp owns 16 tile rows

// K3 streams q tiles of kDkvBq<D> rows (see the note at the top)
template <int D>
constexpr int kDkvBq = D == 64 ? 64 : 32;

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

// K2: dQ for one 64-row q tile of one (batch, query head).
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Hq, int Hkv, int L, float scale, int causal) {
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
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sQ, q + (size_t)bh * L * D, q0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sDO, dout + (size_t)bh * L * D, q0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sK, kb, 0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(sV, vb, 0, L);
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

  float acc_dq[D / 64][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc_dq[c][i] = 0.f;
  }

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
    sm90::cp_async_wait<1>();  // this stage (and Q, dO) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int k0 = it * kTile;
    const uint32_t k_smem = sm90::smem_addr(sK + stage * kTile * D);
    const uint32_t v_smem = sm90::smem_addr(sV + stage * kTile * D);

    // S = Q K^T and dP = dO V^T, 64 rows x 64 keys, K and V read K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(s, sm90::desc_k_major<kTile>(q_smem, kk),
                               sm90::desc_k_major<kTile>(k_smem, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, kTile>(dp, sm90::desc_k_major<kTile>(do_smem, kk),
                               sm90::desc_k_major<kTile>(v_smem, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);

    // dS = P (dP - delta) scale, P = exp(scale s - lse), masked on tiles
    // that cross the diagonal or the end of the sequence
    const bool edge = (causal && k0 + kTile > q0) || k0 + kTile > L;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = i & 2;
      float p = exp2f(s[i] * scale_log2 - (hi ? lse_b : lse_a));
      if (edge) {
        const int k_pos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int q_pos = hi ? row_b : row_a;
        if (k_pos >= L || (causal && k_pos > q_pos)) p = 0.f;
      }
      dp[i] = p * (dp[i] - (hi ? delta_b : delta_a)) * scale;
    }

    // dQ += dS K, dS rounded to the input dtype from registers; K read
    // MN-major ([key][d], the reduction runs over keys)
    uint32_t ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      sm90::acc_to_a<T>(ads[kk], dp + 8 * kk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm90::wgmma_rs_mn<T>(acc_dq[c], ads[kk],
                             sm90::desc_mn_major<kTile>(k_smem, 16 * kk, c));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) sm90::fence_operands(acc_dq[c]);
    __syncthreads();  // done with this stage before it is refilled
  }

  T* out = dq + (size_t)bh * L * D;
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t;
      if (row_a < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
            sm90::pack2<T>(acc_dq[c][4 * j], acc_dq[c][4 * j + 1]);
      if (row_b < L)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) =
            sm90::pack2<T>(acc_dq[c][4 * j + 2], acc_dq[c][4 * j + 3]);
    }
}

// K3: dK and dV for one 64-row k tile of one (batch, KV head), summed over
// the G query heads of its group.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Hq, int Hkv, int L,
                         float scale, int causal) {
  constexpr int BQ = kDkvBq<D>;
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
  const int heads = gridDim.x / nk;  // B * Hkv
  const int bkv = blockIdx.x % heads;
  // causal: the first k tile is seen by every q tile, so it goes first
  const int k0 = (blockIdx.x / heads) * kTile;
  const int b = bkv / Hkv;
  const int G = Hq / Hkv;
  const int bh0 = b * Hq + (bkv - b * Hkv) * G;  // the group's first q head

  const int nq = (L + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;
  const int per = nq - q_first;  // q tiles per query head of the group
  const int n_iter = G * per;    // member-major, as the TPU kernel's grid

  auto load_q = [&](int it, int stage) {
    const int bh = bh0 + it / per;
    const int q0 = (q_first + it % per) * BQ;
    sm90::load_tile_async<T, D, BQ, kMmaThreads>(
        sQ + stage * BQ * D, q + (size_t)bh * L * D, q0, L);
    sm90::load_tile_async<T, D, BQ, kMmaThreads>(
        sDO + stage * BQ * D, dout + (size_t)bh * L * D, q0, L);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x, gq = q0 + i;
      const size_t at = (size_t)bh * L + (gq < L ? gq : 0);
      sm90::cp_async_4(sLse + stage * BQ + i, lse + at, gq < L ? 4 : 0);
      sm90::cp_async_4(sDelta + stage * BQ + i, delta + at, gq < L ? 4 : 0);
    }
  };

  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sK, k + (size_t)bkv * L * D, k0, L);
  sm90::load_tile_async<T, D, kTile, kMmaThreads>(
      sV, v + (size_t)bkv * L * D, k0, L);
  load_q(0, 0);
  sm90::cp_async_commit();

  // this thread's two key rows of the warp's 16: g and g + 8
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_smem = sm90::smem_addr(sK);
  const uint32_t v_smem = sm90::smem_addr(sV);

  float acc_dk[D / 64][32], acc_dv[D / 64][32], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc_dk[c][i] = acc_dv[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_q(it + 1, stage ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this stage (and K, V) have landed
    sm90::fence_proxy_async();
    __syncthreads();

    const int q0 = (q_first + it % per) * BQ;
    const uint32_t q_smem = sm90::smem_addr(sQ + stage * BQ * D);
    const uint32_t do_smem = sm90::smem_addr(sDO + stage * BQ * D);
    const float* tLse = sLse + stage * BQ;
    const float* tDelta = sDelta + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x BQ queries, Q and dO read
    // K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, BQ>(s, sm90::desc_k_major<kTile>(k_smem, kk),
                            sm90::desc_k_major<BQ>(q_smem, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<T, BQ>(dp, sm90::desc_k_major<kTile>(v_smem, kk),
                            sm90::desc_k_major<BQ>(do_smem, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::fence_operands(dp);

    // P^T and dS^T, masked on tiles that cross the diagonal or the end of
    // the sequence; the columns are queries, so lse and delta are per column
    const bool edge = (causal && q0 < k0 + kTile) || q0 + BQ > L;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(tLse + col);
      const float2 dl = *reinterpret_cast<const float2*>(tDelta + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const bool odd = e & 1;
        float p = exp2f(s[i] * scale_log2 - (odd ? ls.y : ls.x) * kLog2e);
        if (edge) {
          const int q_pos = q0 + col + odd;
          const int k_pos = e >= 2 ? key_b : key_a;
          if (q_pos >= L || (causal && q_pos < k_pos)) p = 0.f;
        }
        dp[i] = p * (dp[i] - (odd ? dl.y : dl.x)) * scale;
        s[i] = p;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to the input dtype
    // from registers; dO and Q read MN-major ([query][d], the reduction
    // runs over query rows)
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
      for (int c = 0; c < D / 64; ++c) {
        sm90::wgmma_rs_mn<T>(acc_dv[c], ap[kk],
                             sm90::desc_mn_major<BQ>(do_smem, 16 * kk, c));
        sm90::wgmma_rs_mn<T>(acc_dk[c], ads[kk],
                             sm90::desc_mn_major<BQ>(q_smem, 16 * kk, c));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      sm90::fence_operands(acc_dv[c]);
      sm90::fence_operands(acc_dk[c]);
    }
    __syncthreads();  // done with this stage before it is refilled
  }

  T* dk_out = dk + (size_t)bkv * L * D;
  T* dv_out = dv + (size_t)bkv * L * D;
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t;
      if (key_a < L) {
        const size_t at = (size_t)key_a * D + col;
        *reinterpret_cast<uint32_t*>(dk_out + at) =
            sm90::pack2<T>(acc_dk[c][4 * j], acc_dk[c][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + at) =
            sm90::pack2<T>(acc_dv[c][4 * j], acc_dv[c][4 * j + 1]);
      }
      if (key_b < L) {
        const size_t at = (size_t)key_b * D + col;
        *reinterpret_cast<uint32_t*>(dk_out + at) =
            sm90::pack2<T>(acc_dk[c][4 * j + 2], acc_dk[c][4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dv_out + at) =
            sm90::pack2<T>(acc_dv[c][4 * j + 2], acc_dv[c][4 * j + 3]);
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
};

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq_simt(const Args& a) {
  const size_t smem = dq_simt_smem_bytes<D>();
  if (int err = prepare(flash_bwd_dq_simt_kernel<D>, smem)) return err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hq);
  flash_bwd_dq_simt_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0), a.Hq, a.Hkv, a.L, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_simt(const Args& a) {
  const size_t smem = dkv_simt_smem_bytes<D>();
  if (int err = prepare(flash_bwd_dkv_simt_kernel<D>, smem)) return err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hkv);
  flash_bwd_dkv_simt_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.Hq, a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// one block per (tile, head): tile-major, so the tile rank is the slow index
template <typename T, int D>
int launch_dq_mma(const Args& a) {
  const size_t smem = dq_mma_smem_bytes<D>();
  if (int err = prepare(flash_bwd_dq_mma_kernel<T, D>, smem)) return err;
  const int grid = (a.L + kTile - 1) / kTile * a.B * a.Hq;
  flash_bwd_dq_mma_kernel<T, D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.Hq, a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_mma(const Args& a) {
  const size_t smem = dkv_mma_smem_bytes<D>();
  if (int err = prepare(flash_bwd_dkv_mma_kernel<T, D>, smem)) return err;
  const int grid = (a.L + kTile - 1) / kTile * a.B * a.Hkv;
  flash_bwd_dkv_mma_kernel<T, D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Hq,
      a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (SIMT), 1 = float16, 2 = bfloat16 (tensor cores);
// D in {64, 128}
template <bool kDq>
int dispatch(const Args& a, int D, int dtype) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.L < 1) return -1;
  if (D != 64 && D != 128) return -1;
  const bool d64 = D == 64;
  switch (dtype) {
    case 0:
      if (kDq) return d64 ? launch_dq_simt<64>(a) : launch_dq_simt<128>(a);
      return d64 ? launch_dkv_simt<64>(a) : launch_dkv_simt<128>(a);
    case 1:
      if (kDq)
        return d64 ? launch_dq_mma<__half, 64>(a)
                   : launch_dq_mma<__half, 128>(a);
      return d64 ? launch_dkv_mma<__half, 64>(a)
                 : launch_dkv_mma<__half, 128>(a);
    case 2:
      if (kDq)
        return d64 ? launch_dq_mma<__nv_bfloat16, 64>(a)
                   : launch_dq_mma<__nv_bfloat16, 128>(a);
      return d64 ? launch_dkv_mma<__nv_bfloat16, 64>(a)
                 : launch_dkv_mma<__nv_bfloat16, 128>(a);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// K2. Returns 0 on success, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take (the Python wrapper checks them first).
// lse and delta are (B, Hq, L) fp32; q, dout and dq are (B, Hq, L, D);
// k and v are (B, Hkv, L, D); all contiguous, and for bf16/fp16 the
// (B, H, L, D) tensors 16-byte aligned.
int metisfl_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int Hq, int Hkv, int L, int D,
                         int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, dtype);
}

// K3. As K2, with dk and dv (B, Hkv, L, D) as outputs.
int metisfl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B,
                          int Hq, int Hkv, int L, int D, int dtype,
                          int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, L,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, dtype);
}

const char* metisfl_bwd_error_string(int err) {
  return err < 0 ? "invalid argument" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
