// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (metisfl_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel metisfl_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward through pl.pallas_call). It computes what that
// kernel computes: O = softmax(Q K^T / sqrt(D)) V with an online softmax, an
// unnormalised fp32 accumulator divided once at the store (FlashAttention-2),
// the fp32 logsumexp per query row, and O = 0 for a row with no unmasked key.
//
// Design. One CUDA block of 256 threads owns one (batch*q-head, 64-row q
// tile). A loop inside the block walks the 64-row K/V tiles staged in shared
// memory; it takes the place of the TPU kernel's sequential grid axis and its
// VMEM scratch, since blocks on this card run in parallel and in no order.
// Four threads own one query row: each computes 16 of the tile's 64 scores
// and D/4 of the output columns, and the row's max and sum are reduced over
// the four lanes with shuffles. The running max m, sum l and the accumulator
// stay in fp32 registers. Q, K and V are widened to fp32 in shared memory:
// a product of two bf16 or fp16 values is exact in fp32, so products are
// those of the input dtype, accumulated in fp32. P is rounded to the input
// dtype before the P.V product, as the TPU kernel casts p to v.dtype.
//   - GQA: query head h reads kv head h / (Hq/Hkv); K and V are never
//     repeated in memory.
//   - Causal (q_pos >= k_pos): the loop stops at the last K tile that
//     overlaps the q tile, which skips about half the work.
//   - Ragged L: keys with k_pos >= L are masked and rows >= L are neither
//     loaded nor stored; no padded copy is made.
//   - lse is written in logical layout (B, Hq, L) fp32.
//
// Bound at the serving shape (B=4, Hq=16, Hkv=4, L=1024, D=64, bf16,
// causal): 8.6 GFLOP over 989 TFLOP/s is about 8.7 us; about 21 MB moved
// over 3.35 TB/s is about 6.3 us; so it is bound by operations. This first
// version multiplies on the CUDA cores (not the tensor cores) and reads
// shared memory once per multiply-add, so it runs far above that bound;
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // key rows per loop step
constexpr int kThreads = 256; // 4 threads per query row
constexpr float kNeg = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float so the four lanes of a row (and the
  // eight rows of a warp) fall in distinct banks; P padded likewise.
  return sizeof(float) * (size_t)(kBlockM * (D + 1) + kBlockN * (D + 1) +
                                  kBlockN * D + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int L,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                          // kBlockM x (D + 1)
  float* sK = sQ + kBlockM * (D + 1);        // kBlockN x (D + 1)
  float* sV = sK + kBlockN * (D + 1);        // kBlockN x D
  float* sP = sV + kBlockN * D;              // kBlockM x (kBlockN + 1)

  const int tid = threadIdx.x;
  const int row = tid >> 2;       // query row inside the tile
  const int sub = tid & 3;        // which quarter of the row's columns
  const int bh = blockIdx.y;      // b * Hq + h
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBlockM;
  const int q_pos = q0 + row;

  const T* qb = q + (size_t)bh * L * D;
  const T* kb = k + (size_t)kvh * L * D;
  const T* vb = v + (size_t)kvh * L * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int g = q0 + r;
    sQ[r * (D + 1) + d] = g < L ? to_f32(qb[(size_t)g * D + d]) : 0.f;
  }

  float m = kNeg, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  // causal: the last key tile that overlaps this q tile (q0 + kBlockM - 1)
  const int k_end = causal ? min(L, q0 + kBlockM) : L;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous step is done with sK / sV
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      const int g = k0 + r;
      const bool in = g < L;
      sK[r * (D + 1) + d] = in ? to_f32(kb[(size_t)g * D + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vb[(size_t)g * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kBlockN / 4];
#pragma unroll
    for (int j = 0; j < kBlockN / 4; ++j) s[j] = 0.f;
    const float* qrow = sQ + row * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kBlockN / 4; ++j)
        s[j] = fmaf(qd, sK[(sub + 4 * j) * (D + 1) + d], s[j]);
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBlockN / 4; ++j) {
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
    for (int j = 0; j < kBlockN / 4; ++j) {
      const float p = s[j] > kNeg ? expf(s[j] - m_next) : 0.f;
      psum += p;
      sP[row * (kBlockN + 1) + sub + 4 * j] = to_f32(from_f32<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_next;
    __syncwarp();  // a row's P is written and read by the same four lanes

    const float* prow = sP + row * (kBlockN + 1);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * D + sub;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (q_pos < L) {
    // a row with no unmasked key has l == 0: store 0, not nan
    const float inv = l == 0.f ? 0.f : 1.f / l;
    T* orow = o + ((size_t)bh * L + q_pos) * D + sub;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[4 * j] = from_f32<T>(acc[j] * inv);
    if (sub == 0) lse[(size_t)bh * L + q_pos] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int L, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * Hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, L, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Hq, int Hkv, int L, int D, float scale,
             int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, L, scale, causal,
                         stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, L, scale, causal,
                          stream);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Returns 0 on success, the
// cudaError_t of a refused launch, or -1 for arguments the kernel does not
// take (the Python wrapper checks them first).
int metisfl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Hq, int Hkv, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || L < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, lse_f, B, Hq, Hkv, L, D, scale,
                             causal, s);
    case 1:
      return launch_d<__half>(q, k, v, o, lse_f, B, Hq, Hkv, L, D, scale,
                              causal, s);
    case 2:
      return launch_d<__nv_bfloat16>(q, k, v, o, lse_f, B, Hq, Hkv, L, D,
                                     scale, causal, s);
    default:
      return -1;
  }
}

const char* metisfl_cuda_error_string(int err) {
  return err < 0 ? "invalid argument" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
