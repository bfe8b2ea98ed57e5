// Coefficient-packed CKKS-style RLWE homomorphic encryption (C++17).
//
// The port's copy of the JAX package's native/ckks.cc (the same keys,
// ciphertext layout and arithmetic, so either package's library reads the
// other's keys and ciphertexts). A redesign of the reference's Palisade
// CKKS scheme
// (reference metisfl/encryption/palisade/ckks_scheme.cc:13-252,
// he_scheme.h:20-42). The reference's aggregation path uses exactly two
// homomorphic ops — EvalMult by a plaintext scalar and EvalAdd
// (private_weighted_average.cc:22-111) — so this implementation packs
// values into polynomial *coefficients* instead of canonical-embedding
// slots: both required ops are coefficient-wise, no rotation/relinearization
// keys are needed, every ciphertext packs N (not N/2) values, and the
// ciphertext expansion is 2 u64 per value (~16x denser than the reference's
// observed ~100 MB CIFAR models, controller.cc:594-604). Security is
// standard RLWE (the encoding does not affect hardness): ring Z_q[X]/(X^N+1),
// N = 8192, log2 q ≈ 59, ternary secret, centered-binomial noise (sigma ~ 3.2),
// ChaCha20 CSPRNG keyed from the OS entropy pool. Parameter justification
// (HE-standard table comparison: log2 q is ~half the 256-bit classical
// ceiling at N=8192/ternary) and the full noise-budget derivation live in
// docs/SECURITY.md; tests/test_ckks.py::test_noise_budget_at_max_scalar_scale
// checks the worst-case bound.
//
// Weighted average: ct_out = sum_i round(2^S_BITS * s_i) * ct_i  (mod q).
// Fresh ciphertexts carry plaintext scale 2^V_BITS; the sum carries
// 2^(V_BITS+S_BITS); decrypt divides by the scale in the payload header.
//
// C ABI at the bottom; Python binds via ctypes (pybind11 is not available
// in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <random>
#include <string>
#include <vector>

namespace {

constexpr int LOGN = 13;
constexpr int N = 1 << LOGN;                     // 8192 coefficients/values
constexpr uint64_t Q = 576460752303439873ULL;    // prime, Q ≡ 1 (mod 2N), 2^59+2^14+1
constexpr uint64_t PSI = 572686754113469876ULL;  // primitive 2N-th root of unity
constexpr uint64_t PSI_INV = 509288606595595249ULL;
constexpr uint64_t N_INV = 576390383559262207ULL;

constexpr int V_BITS = 32;  // fresh-ciphertext plaintext scale 2^32
constexpr int S_BITS = 20;  // scalar scale in weighted sums (quantization ~1e-6)

constexpr uint32_t MAGIC = 0x31544b43u;  // "CKT1"

inline uint64_t addmod(uint64_t a, uint64_t b) {
  uint64_t r = a + b;
  return r >= Q ? r - Q : r;
}
inline uint64_t submod(uint64_t a, uint64_t b) {
  return a >= b ? a - b : a + Q - b;
}
inline uint64_t mulmod(uint64_t a, uint64_t b) {
  return (uint64_t)((unsigned __int128)a * b % Q);
}

// Shoup modular multiplication: for a fixed factor w < Q, precompute
// w' = floor(w * 2^64 / Q); then a*w mod Q costs two 64x64 multiplies and
// one conditional subtract instead of a 128-bit division (~8x faster —
// this is the NTT hot path; the same precomputed-quotient trick every
// lattice library uses). Correct for ANY a < 2^64: the estimated quotient
// q is off by at most 1, so r = a*w - q*Q lands in [0, 2Q).
inline uint64_t shoup_of(uint64_t w) {
  return (uint64_t)(((unsigned __int128)w << 64) / Q);
}
inline uint64_t mulmod_shoup(uint64_t a, uint64_t w, uint64_t w_shoup) {
  uint64_t q = (uint64_t)(((unsigned __int128)a * w_shoup) >> 64);
  uint64_t r = a * w - q * Q;
  return r >= Q ? r - Q : r;
}

// any 64-bit word -> [0, Q) without a division (Shoup multiply by 1);
// used to sanitize untrusted ciphertext words before addmod/submod
inline uint64_t reduce64(uint64_t a) {
  static const uint64_t ONE_SH = shoup_of(1);
  return mulmod_shoup(a, 1, ONE_SH);
}

// ---------------------------------------------------------------------- //
// negacyclic NTT (iterative CT/GS with merged psi powers)
// ---------------------------------------------------------------------- //

struct Tables {
  uint64_t psi_rev[N];            // psi^brv(i)
  uint64_t psi_inv_rev[N];        // psi^-brv(i)
  uint64_t psi_rev_sh[N];         // Shoup quotients of the above
  uint64_t psi_inv_rev_sh[N];
  uint64_t n_inv_sh;
  Tables() {
    uint64_t pow_psi[N], pow_psi_inv[N];
    pow_psi[0] = pow_psi_inv[0] = 1;
    for (int i = 1; i < N; i++) {
      pow_psi[i] = mulmod(pow_psi[i - 1], PSI);
      pow_psi_inv[i] = mulmod(pow_psi_inv[i - 1], PSI_INV);
    }
    for (int i = 0; i < N; i++) {
      uint32_t r = 0, x = (uint32_t)i;
      for (int b = 0; b < LOGN; b++) { r = (r << 1) | (x & 1); x >>= 1; }
      psi_rev[i] = pow_psi[r];
      psi_inv_rev[i] = pow_psi_inv[r];
      psi_rev_sh[i] = shoup_of(psi_rev[i]);
      psi_inv_rev_sh[i] = shoup_of(psi_inv_rev[i]);
    }
    n_inv_sh = shoup_of(N_INV);
  }
};
const Tables& tables() { static Tables t; return t; }

// Both transforms use Harvey-style lazy reduction: butterfly values live in
// [0, 4Q) (forward) / [0, 2Q) (inverse) — Q < 2^60 leaves headroom — and the
// per-butterfly conditional subtracts collapse into one final pass. The
// lazy Shoup product returns a value in [0, 2Q) for ANY 64-bit input.
inline uint64_t mulmod_shoup_lazy(uint64_t a, uint64_t w, uint64_t w_shoup) {
  uint64_t q = (uint64_t)(((unsigned __int128)a * w_shoup) >> 64);
  return a * w - q * Q;
}

constexpr uint64_t Q2 = 2 * Q;

void ntt(uint64_t* a) {  // inputs < Q, outputs < Q
  const Tables& T = tables();
  int t = N;
  for (int m = 1; m < N; m <<= 1) {
    t >>= 1;
    for (int i = 0; i < m; i++) {
      const uint64_t S = T.psi_rev[m + i];
      const uint64_t Ssh = T.psi_rev_sh[m + i];
      const int j1 = 2 * i * t;
      for (int j = j1; j < j1 + t; j++) {
        uint64_t U = a[j];                                 // < 4Q
        if (U >= Q2) U -= Q2;                              // < 2Q
        const uint64_t V = mulmod_shoup_lazy(a[j + t], S, Ssh);  // < 2Q
        a[j] = U + V;                                      // < 4Q
        a[j + t] = U + Q2 - V;                             // < 4Q
      }
    }
  }
  for (int j = 0; j < N; j++) {
    uint64_t v = a[j];
    if (v >= Q2) v -= Q2;
    if (v >= Q) v -= Q;
    a[j] = v;
  }
}

void intt(uint64_t* a) {  // inputs < Q, outputs < Q
  const Tables& T = tables();
  int t = 1;
  for (int m = N; m > 1; m >>= 1) {
    const int h = m >> 1;
    int j1 = 0;
    for (int i = 0; i < h; i++) {
      const uint64_t S = T.psi_inv_rev[h + i];
      const uint64_t Ssh = T.psi_inv_rev_sh[h + i];
      for (int j = j1; j < j1 + t; j++) {
        const uint64_t U = a[j];                           // < 2Q
        const uint64_t V = a[j + t];                       // < 2Q
        const uint64_t s = U + V;                          // < 4Q
        a[j] = s >= Q2 ? s - Q2 : s;                       // < 2Q
        a[j + t] = mulmod_shoup_lazy(U + Q2 - V, S, Ssh);  // < 2Q
      }
      j1 += 2 * t;
    }
    t <<= 1;
  }
  // the strict Shoup product both scales by N^-1 and lands in [0, Q)
  for (int j = 0; j < N; j++) a[j] = mulmod_shoup(a[j], N_INV, T.n_inv_sh);
}

// ---------------------------------------------------------------------- //
// ChaCha20 CSPRNG (RFC 8439 block function), keyed from std::random_device
// ---------------------------------------------------------------------- //

struct ChaCha {
  uint32_t key[8];
  uint64_t counter = 0;
  uint8_t buf[64];
  int pos = 64;
  uint64_t tern_bits = 0;  // batched 2-bit pool for ternary()
  int tern_left = 0;

  explicit ChaCha() {
    std::random_device rd;  // /dev/urandom on Linux
    for (int i = 0; i < 8; i++) key[i] = (uint32_t)rd();
  }

  static inline uint32_t rotl(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
  }
  static inline void qr(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
    a += b; d ^= a; d = rotl(d, 16);
    c += d; b ^= c; b = rotl(b, 12);
    a += b; d ^= a; d = rotl(d, 8);
    c += d; b ^= c; b = rotl(b, 7);
  }

  void block() {
    uint32_t s[16] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574,
                      key[0], key[1], key[2], key[3],
                      key[4], key[5], key[6], key[7],
                      (uint32_t)counter, (uint32_t)(counter >> 32), 0, 0};
    uint32_t x[16];
    std::memcpy(x, s, sizeof(x));
    for (int r = 0; r < 10; r++) {
      qr(x[0], x[4], x[8], x[12]);  qr(x[1], x[5], x[9], x[13]);
      qr(x[2], x[6], x[10], x[14]); qr(x[3], x[7], x[11], x[15]);
      qr(x[0], x[5], x[10], x[15]); qr(x[1], x[6], x[11], x[12]);
      qr(x[2], x[7], x[8], x[13]);  qr(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; i++) x[i] += s[i];
    std::memcpy(buf, x, 64);
    counter++;
    pos = 0;
  }

  uint64_t u64() {
    if (pos > 56) block();
    uint64_t v;
    std::memcpy(&v, buf + pos, 8);
    pos += 8;
    return v;
  }

  // uniform in [0, Q) by rejection
  uint64_t uniform_q() {
    constexpr uint64_t LIMIT = UINT64_MAX - (UINT64_MAX % Q);
    uint64_t v;
    do { v = u64(); } while (v >= LIMIT);
    return v % Q;
  }

  // uniform ternary {-1, 0, 1} as residues mod Q; draws 2-bit chunks from
  // a batched 64-bit pool (32 chunks per CSPRNG word instead of one)
  uint64_t ternary() {
    for (;;) {
      if (tern_left == 0) { tern_bits = u64(); tern_left = 32; }
      uint64_t v = tern_bits & 3;
      tern_bits >>= 2;
      tern_left--;
      if (v != 3) return v == 2 ? Q - 1 : v;  // 0, 1, or -1 mod Q
    }
  }

  // centered binomial with eta=21: sigma = sqrt(21/2) ~= 3.24
  uint64_t cbd() {
    uint64_t bits = u64();
    int a = __builtin_popcountll(bits & ((1ULL << 21) - 1));
    int b = __builtin_popcountll((bits >> 21) & ((1ULL << 21) - 1));
    int e = a - b;
    return e >= 0 ? (uint64_t)e : Q - (uint64_t)(-e);
  }
};

thread_local ChaCha g_rng;

// ---------------------------------------------------------------------- //
// keys and context
// ---------------------------------------------------------------------- //

struct Ctx {
  bool has_public = false;
  bool has_secret = false;
  std::vector<uint64_t> b_ntt;  // pk0 = -(a*s) + e, NTT domain
  std::vector<uint64_t> a_ntt;  // pk1, NTT domain
  std::vector<uint64_t> s_ntt;  // secret, NTT domain
  std::vector<uint64_t> b_sh;   // Shoup quotients for the pointwise products
  std::vector<uint64_t> a_sh;
  std::vector<uint64_t> s_sh;
};

std::vector<uint64_t> shoup_table(const std::vector<uint64_t>& w) {
  std::vector<uint64_t> sh(w.size());
  for (size_t i = 0; i < w.size(); i++) sh[i] = shoup_of(w[i]);
  return sh;
}

bool write_file(const std::string& path, const void* data, size_t size) {
  std::ofstream f(path, std::ios::binary | std::ios::trunc);
  if (!f) return false;
  f.write((const char*)data, (std::streamsize)size);
  return (bool)f;
}

bool read_file(const std::string& path, std::vector<uint64_t>& out, size_t n) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  out.resize(n);
  f.read((char*)out.data(), (std::streamsize)(n * 8));
  return (bool)f;
}

// payload header
struct Header {
  uint32_t magic;
  uint32_t scale_bits;
  uint64_t n_values;
  uint32_t n_blocks;
  uint32_t reserved;
};
static_assert(sizeof(Header) == 24, "header layout");

inline long payload_size(long n_values) {
  long blocks = (n_values + N - 1) / N;
  return (long)sizeof(Header) + blocks * 2L * N * 8L;
}

}  // namespace

// ---------------------------------------------------------------------- //
// C ABI
// ---------------------------------------------------------------------- //

extern "C" {

long ckks_n() { return N; }

long ckks_ciphertext_size(long n_values) { return payload_size(n_values); }

// Generate (pk, sk) into dir/{pk.bin, sk.bin}. pk.bin = b||a (2N u64);
// sk.bin = s (N u64). Mirrors GenCryptoContextAndKeys writing key files
// (ckks_scheme.cc:13-75) minus the eval-mult key (not needed: no ct*ct).
int ckks_keygen(const char* dir) {
  std::vector<uint64_t> s(N), a(N), e(N), b(N);
  for (int i = 0; i < N; i++) s[i] = g_rng.ternary();
  for (int i = 0; i < N; i++) a[i] = g_rng.uniform_q();
  for (int i = 0; i < N; i++) e[i] = g_rng.cbd();

  std::vector<uint64_t> s_ntt(s), a_ntt(a);
  ntt(s_ntt.data());
  ntt(a_ntt.data());
  std::vector<uint64_t> as(N);
  for (int i = 0; i < N; i++) as[i] = mulmod(a_ntt[i], s_ntt[i]);
  intt(as.data());
  for (int i = 0; i < N; i++) b[i] = addmod(submod(0, as[i]), e[i]);

  std::string d(dir);
  std::vector<uint64_t> pk(2 * N);
  std::memcpy(pk.data(), b.data(), N * 8);
  std::memcpy(pk.data() + N, a.data(), N * 8);
  if (!write_file(d + "/pk.bin", pk.data(), 2 * N * 8)) return -1;
  if (!write_file(d + "/sk.bin", s.data(), N * 8)) return -2;
  return 0;
}

void* ckks_open(const char* dir, int load_secret) {
  auto* ctx = new Ctx();
  std::string d(dir);
  std::vector<uint64_t> pk;
  if (read_file(d + "/pk.bin", pk, 2 * N)) {
    ctx->b_ntt.assign(pk.begin(), pk.begin() + N);
    ctx->a_ntt.assign(pk.begin() + N, pk.end());
    ntt(ctx->b_ntt.data());
    ntt(ctx->a_ntt.data());
    ctx->b_sh = shoup_table(ctx->b_ntt);
    ctx->a_sh = shoup_table(ctx->a_ntt);
    ctx->has_public = true;
  }
  if (load_secret) {
    std::vector<uint64_t> s;
    if (read_file(d + "/sk.bin", s, N)) {
      ctx->s_ntt = s;
      ntt(ctx->s_ntt.data());
      ctx->s_sh = shoup_table(ctx->s_ntt);
      ctx->has_secret = true;
    }
  }
  if (!ctx->has_public && !(load_secret && ctx->has_secret)) {
    delete ctx;
    return nullptr;
  }
  return ctx;
}

void ckks_close(void* ctx) { delete (Ctx*)ctx; }

int ckks_has_secret(void* ctx) { return ((Ctx*)ctx)->has_secret ? 1 : 0; }

// Encrypt n doubles -> payload. Returns bytes written or <0 on error.
long ckks_encrypt(void* vctx, const double* vals, long n,
                  unsigned char* out, long cap) {
  auto* ctx = (Ctx*)vctx;
  if (!ctx->has_public) return -1;
  const long need = payload_size(n);
  if (cap < need) return -2;
  const long blocks = (n + N - 1) / N;

  Header h{MAGIC, V_BITS, (uint64_t)n, (uint32_t)blocks, 0};
  std::memcpy(out, &h, sizeof(h));
  uint64_t* body = (uint64_t*)(out + sizeof(Header));
  const double scale = (double)(1ULL << V_BITS);

  std::atomic<int> fail{0};
#pragma omp parallel for schedule(static)
  for (long blk = 0; blk < blocks; blk++) {
    uint64_t m[N], u[N], c[N];
    const long base = blk * N;
    for (int i = 0; i < N; i++) {
      double v = (base + i < n) ? vals[base + i] : 0.0;
      double sv = v * scale;
      // |v| <= 63 keeps sum_i round(2^S_BITS s_i) * m_i inside (-q/2, q/2)
      // for any convex weights, so every encryptable payload is safely
      // weighted-summable; model weights are orders of magnitude smaller
      if (sv > 63.0 * scale || sv < -63.0 * scale) { fail.store(1); sv = 0.0; }
      long long iv = (long long)(sv >= 0 ? sv + 0.5 : sv - 0.5);
      m[i] = iv >= 0 ? (uint64_t)iv % Q : Q - (uint64_t)(-iv) % Q;
    }
    for (int i = 0; i < N; i++) u[i] = g_rng.ternary();
    ntt(u);
    uint64_t* c0 = body + blk * 2 * N;
    uint64_t* c1 = c0 + N;
    for (int i = 0; i < N; i++)
      c[i] = mulmod_shoup(u[i], ctx->b_ntt[i], ctx->b_sh[i]);
    intt(c);
    for (int i = 0; i < N; i++)
      c0[i] = addmod(addmod(c[i], g_rng.cbd()), m[i]);
    for (int i = 0; i < N; i++)
      c[i] = mulmod_shoup(u[i], ctx->a_ntt[i], ctx->a_sh[i]);
    intt(c);
    for (int i = 0; i < N; i++) c1[i] = addmod(c[i], g_rng.cbd());
  }
  return fail.load() ? -3 : need;
}

// ct_out = sum_i round(2^S_BITS * scales[i]) * ct_i. Keyless.
long ckks_weighted_sum(const unsigned char* const* payloads, const long* sizes,
                       const double* scales, long k,
                       unsigned char* out, long cap) {
  if (k <= 0) return -1;
  Header h0;
  std::memcpy(&h0, payloads[0], sizeof(h0));
  if (h0.magic != MAGIC || h0.scale_bits != V_BITS) return -2;
  const long need = payload_size((long)h0.n_values);
  if (cap < need) return -3;
  for (long i = 0; i < k; i++) {
    Header hi;
    if (sizes[i] < (long)sizeof(Header)) return -4;
    std::memcpy(&hi, payloads[i], sizeof(hi));
    if (hi.magic != MAGIC || hi.n_values != h0.n_values ||
        hi.scale_bits != V_BITS || sizes[i] != need)
      return -4;
  }
  std::vector<uint64_t> fp(k), fp_sh(k);
  for (long i = 0; i < k; i++) {
    double s = scales[i] * (double)(1 << S_BITS);
    long long iv = (long long)(s >= 0 ? s + 0.5 : s - 0.5);
    fp[i] = iv >= 0 ? (uint64_t)iv % Q : Q - (uint64_t)(-iv) % Q;
    fp_sh[i] = shoup_of(fp[i]);
  }

  Header h{MAGIC, V_BITS + S_BITS, h0.n_values, h0.n_blocks, 0};
  std::memcpy(out, &h, sizeof(h));
  uint64_t* obody = (uint64_t*)(out + sizeof(Header));
  const long words = (long)h0.n_blocks * 2L * N;

#pragma omp parallel for schedule(static)
  for (long w = 0; w < words; w++) {
    uint64_t acc = 0;
    for (long i = 0; i < k; i++) {
      const uint64_t* body = (const uint64_t*)(payloads[i] + sizeof(Header));
      // mulmod_shoup reduces any 64-bit word mod Q — malformed (>= Q)
      // payload words stay correctly reduced
      acc = addmod(acc, mulmod_shoup(body[w], fp[i], fp_sh[i]));
    }
    obody[w] = acc;
  }
  return need;
}

// Decrypt payload -> n doubles. Divides by the header's plaintext scale.
long ckks_decrypt(void* vctx, const unsigned char* payload, long size,
                  double* out, long n) {
  auto* ctx = (Ctx*)vctx;
  if (!ctx->has_secret) return -1;
  if (size < (long)sizeof(Header)) return -2;
  Header h;
  std::memcpy(&h, payload, sizeof(h));
  if (h.magic != MAGIC) return -2;
  if ((long)h.n_values < n) return -3;
  if (size != payload_size((long)h.n_values)) return -2;
  // The header travels through the (honest-but-curious) aggregator; only
  // the two scales the protocol can legitimately produce are accepted —
  // a fresh ciphertext (2^V_BITS) or a weighted sum (2^(V_BITS+S_BITS)).
  // Anything else would let a malicious aggregator rescale the recovered
  // model undetected. (No MAC/freshness beyond this: the threat model is
  // the reference's honest-but-curious controller, he_scheme.h.)
  if (h.scale_bits != V_BITS && h.scale_bits != V_BITS + S_BITS) return -4;
  const double inv_scale = 1.0 / (double)(1ULL << h.scale_bits);
  const uint64_t* body = (const uint64_t*)(payload + sizeof(Header));
  const long blocks = h.n_blocks;

#pragma omp parallel for schedule(static)
  for (long blk = 0; blk < blocks; blk++) {
    const long base = blk * N;
    if (base >= n) continue;
    uint64_t t[N];
    const uint64_t* c0 = body + blk * 2 * N;
    const uint64_t* c1 = c0 + N;
    // untrusted payload words may be >= Q; sanitize into the ring first
    for (int i = 0; i < N; i++) t[i] = reduce64(c1[i]);
    ntt(t);
    for (int i = 0; i < N; i++)
      t[i] = mulmod_shoup(t[i], ctx->s_ntt[i], ctx->s_sh[i]);
    intt(t);
    for (int i = 0; i < N; i++) {
      if (base + i >= n) break;
      uint64_t m = addmod(reduce64(c0[i]), t[i]);
      // centered representative in (-q/2, q/2]
      double signed_m = (m > Q / 2) ? -(double)(Q - m) : (double)m;
      out[base + i] = signed_m * inv_scale;
    }
  }
  return n;
}

// NTT + encrypt/decrypt self-check without touching the filesystem.
// Returns 0 on success.
int ckks_selftest() {
  // NTT roundtrip
  std::vector<uint64_t> a(N), ref;
  for (int i = 0; i < N; i++) a[i] = g_rng.uniform_q();
  ref = a;
  ntt(a.data());
  intt(a.data());
  if (a != ref) return 1;
  // negacyclic convolution vs schoolbook on a sparse pair:
  // p = x^3 + 2, r = 5x^(N-1) + 7 -> p*r mod (x^N+1):
  //   35 x^2 (wrap of 5x^(N+2), negated twice? compute directly below)
  std::vector<uint64_t> p(N, 0), r(N, 0);
  p[3] = 1; p[0] = 2;
  r[N - 1] = 5; r[0] = 7;
  std::vector<uint64_t> want(N, 0);
  // (x^3 + 2)(5x^(N-1) + 7) = 5x^(N+2) + 7x^3 + 10x^(N-1) + 14
  // x^(N+2) = -x^2  ->  -5x^2
  want[2] = submod(0, 5);
  want[3] = 7;
  want[N - 1] = 10;
  want[0] = 14;
  ntt(p.data());
  ntt(r.data());
  for (int i = 0; i < N; i++) p[i] = mulmod(p[i], r[i]);
  intt(p.data());
  if (p != want) return 2;
  return 0;
}

}  // extern "C"
