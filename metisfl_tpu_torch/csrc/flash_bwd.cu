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
// dS K and dS^T Q, P to the input dtype before P^T dO. Operands are widened
// to fp32 in shared memory; a product of two bf16 or fp16 values is exact in
// fp32, so fp32 FMAs give the input dtype's products with fp32 sums.
//
// Design. Blocks of 256 threads; four threads own one row of the block's
// 64-row tile and split its 64 columns (and its D output columns) four ways,
// as the forward kernel (flash_fwd.cu) does.
//   - K2: one block per (64-row q tile, b * Hq + h). Q, dO, lse and delta
//     are loaded once; a loop walks the 64-row K/V tiles (up to the diagonal
//     when causal) and dQ stays in fp32 registers until one store.
//   - K3: one block per (64-row k tile, b * Hkv + h_kv). K and V are loaded
//     once; a loop walks the G query heads of the KV group (member-major, as
//     the TPU kernel's sequential grid axis does) and, within each, the q
//     tiles from the first that overlaps the k tile (causal) to the last.
//     dK and dV stay in fp32 registers for the whole loop: no atomics, so
//     they are the same bits on every run.
//   - Ragged L without padding: keys and queries at positions >= L are
//     masked (P = 0, their lse is never read) and only rows < L are stored.
//     The TPU path pads lse with a 1e30 sentinel instead.
//
// Bound at the training shape (B=8, Hq=16, Hkv=4, L=1024, D=64, bf16,
// causal; 524,800 (q, k) pairs per head, 128 heads): K2 does 6 D operations
// per pair, 25.8 GFLOP, 26 us at 989 TFLOP/s; K3 does 8 D, 34.4 GFLOP,
// 35 us; each moves about 60 MB (18 us at 3.35 TB/s); so both are bound by
// operations. This first version multiplies on the CUDA cores and reads
// shared memory once per multiply-add, so it runs far above that bound;
// tensor cores (mma.sync, wgmma with TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 4 threads per tile row
constexpr int kCols = kTile / 4;  // tile columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the TPU kernels' astype before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rows [r0, r0 + kTile) of a (L, D) matrix into an fp32 tile with rows
// padded to D + 1 floats (the four lanes of a row and the eight rows of a
// warp then fall in distinct banks); rows >= L are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int L) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int g = r0 + r;
    dst[r * (D + 1) + d] = g < L ? to_f32(src[(size_t)g * D + d]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles and the dS tile
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles, and one tile's lse and delta
  return sizeof(float) *
         (size_t)(4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

// K2: dQ for one 64-row q tile of one (batch, query head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int L, float scale, int causal) {
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

  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;
  // a row past L takes no part: its P is 0 and its lse is never read
  const float row_lse = row_in ? lse[(size_t)bh * L + q_pos] : 0.f;
  const float row_delta = row_in ? delta[(size_t)bh * L + q_pos] : 0.f;

  load_tile<T, D>(sQ, q + (size_t)bh * L * D, q0, L);
  load_tile<T, D>(sDO, dout + (size_t)bh * L * D, q0, L);

  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous step is done with sK / sV
    load_tile<T, D>(sK, kb, k0, L);
    load_tile<T, D>(sV, vb, k0, L);
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
      const float ds = p * (dp[j] - row_delta) * scale;
      sDS[row * (kTile + 1) + sub + 4 * j] = round_to<T>(ds);
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
    T* out = dq + ((size_t)bh * L + q_pos) * D + sub;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) out[4 * j] = from_f32<T>(acc[j]);
  }
}

// K3: dK and dV for one 64-row k tile of one (batch, KV head), summed over
// the G query heads of its group.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int L, float scale,
                     int causal) {
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

  load_tile<T, D>(sK, k + (size_t)bkv * L * D, k0, L);
  load_tile<T, D>(sV, v + (size_t)bkv * L * D, k0, L);

  float acc_k[D / 4], acc_v[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc_k[j] = acc_v[j] = 0.f;

  // causal: q tiles before the k tile's first row see none of its keys
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + hkv * G + g;
    const T* qb = q + (size_t)bh * L * D;
    const T* dob = dout + (size_t)bh * L * D;
    const float* lseb = lse + (size_t)bh * L;
    const float* deltab = delta + (size_t)bh * L;
    for (int q0 = q_begin; q0 < L; q0 += kTile) {
      __syncthreads();  // the previous step is done with sQ / sDO / stats
      load_tile<T, D>(sQ, qb, q0, L);
      load_tile<T, D>(sDO, dob, q0, L);
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
        const float ds = p * (dp[j] - sDelta[c]) * scale;
        sP[row * (kTile + 1) + c] = round_to<T>(p);
        sDS[row * (kTile + 1) + c] = round_to<T>(ds);
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
      dk[at + 4 * j] = from_f32<T>(acc_k[j]);
      dv[at + 4 * j] = from_f32<T>(acc_v[j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq (K2) or dk, dv (K3)
  int B, Hq, Hkv, L;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hq);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.Hq, a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.Hq,
      a.Hkv, a.L, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; D in {64, 128}
template <bool kDq>
int dispatch(const Args& a, int D, int dtype) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.L < 1) return -1;
#define METISFL_BWD_CASE(T, DD)                                   \
  if (D == DD) return kDq ? launch_dq<T, DD>(a) : launch_dkv<T, DD>(a);
  switch (dtype) {
    case 0:
      METISFL_BWD_CASE(float, 64)
      METISFL_BWD_CASE(float, 128)
      return -1;
    case 1:
      METISFL_BWD_CASE(__half, 64)
      METISFL_BWD_CASE(__half, 128)
      return -1;
    case 2:
      METISFL_BWD_CASE(__nv_bfloat16, 64)
      METISFL_BWD_CASE(__nv_bfloat16, 128)
      return -1;
    default:
      return -1;
  }
#undef METISFL_BWD_CASE
}

}  // namespace

extern "C" {

// K2. Returns 0 on success, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take (the Python wrapper checks them first).
// lse and delta are (B, Hq, L) fp32; q, dout and dq are (B, Hq, L, D);
// k and v are (B, Hkv, L, D); all contiguous.
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
