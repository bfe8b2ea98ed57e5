// Host-side federated fold: acc[i] (+)= sum_j scales[j] * models[j][i].
//
// The controller's cross-host aggregation hot loop (the reference runs it
// as per-variable byte arithmetic under OpenMP, federated_average.cc:70-150;
// the rebuild's numpy path stacks the block then GEMVs — one extra full
// copy of every model). This kernel streams each model exactly once and
// touches the accumulator once per cache block: traffic = k*n reads + n
// writes, the memory-bandwidth floor for the operation. OpenMP splits the
// value range; models are only read, so no synchronization is needed.
//
// C ABI (ctypes): see metisfl_tpu_torch/native/__init__.py load_hostfold().
//
// The port's copy of the JAX package's native/hostfold.cc, the same source
// and the same g++ flags, so both packages fold to the same bits on one
// host: ISO -std=c++17 keeps -ffp-contract=off (no fused multiply-add), so
// each a[i] += s * m[i] rounds the product and the sum apart, in one fixed
// order per value whatever the thread count.

#include <cstdint>

extern "C" {

// f32 models, f32 accumulator (the federated hot path: wire dtype f32).
// init != 0 zeroes the accumulator first.
void hostfold_f32(float* acc, const float* const* models,
                  const double* scales, long k, long n, int init) {
  constexpr long BLK = 8192;  // L2-friendly value block
#pragma omp parallel for schedule(static)
  for (long b0 = 0; b0 < n; b0 += BLK) {
    const long b1 = b0 + BLK < n ? b0 + BLK : n;
    if (init) {
      for (long i = b0; i < b1; i++) acc[i] = 0.0f;
    }
    for (long j = 0; j < k; j++) {
      const float* __restrict m = models[j];
      const float s = (float)scales[j];
      float* __restrict a = acc;
      for (long i = b0; i < b1; i++) a[i] += s * m[i];
    }
  }
}

// f64 variant (64-bit trees folded on the host).
void hostfold_f64(double* acc, const double* const* models,
                  const double* scales, long k, long n, int init) {
  constexpr long BLK = 4096;
#pragma omp parallel for schedule(static)
  for (long b0 = 0; b0 < n; b0 += BLK) {
    const long b1 = b0 + BLK < n ? b0 + BLK : n;
    if (init) {
      for (long i = b0; i < b1; i++) acc[i] = 0.0;
    }
    for (long j = 0; j < k; j++) {
      const double* __restrict m = models[j];
      const double s = scales[j];
      double* __restrict a = acc;
      for (long i = b0; i < b1; i++) a[i] += s * m[i];
    }
  }
}

int hostfold_selftest() {
  float a[4] = {1, 1, 1, 1};
  float m0[4] = {1, 2, 3, 4};
  float m1[4] = {4, 3, 2, 1};
  const float* ms[2] = {m0, m1};
  double sc[2] = {0.5, 0.5};
  hostfold_f32(a, ms, sc, 2, 4, 1);
  for (int i = 0; i < 4; i++) {
    if (a[i] < 2.49f || a[i] > 2.51f) return 1;
  }
  return 0;
}

}  // extern "C"
