// GF(2^8) / Reed-Solomon CPU oracle.
//
// Native (C++) ground-truth for the TPU kernels in hbbft_tpu/ops/{gf256,rs}.py,
// playing the role the `reed-solomon-erasure` crate plays for the reference's
// reliable broadcast (src/broadcast/broadcast.rs). Field: poly 0x11D, gen 2.
// Exposed via a C ABI and loaded with ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

struct Tables {
  uint8_t exp[512];
  int32_t log[256];
  Tables() {
    int x = 1;
    for (int i = 0; i < 255; ++i) {
      exp[i] = static_cast<uint8_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 512; ++i) exp[i] = exp[i - 255];
    log[0] = 0;
  }
};
const Tables T;

inline uint8_t gf_mul(uint8_t a, uint8_t b) {
  if (a == 0 || b == 0) return 0;
  return T.exp[T.log[a] + T.log[b]];
}

inline uint8_t gf_inv(uint8_t a) { return T.exp[255 - T.log[a]]; }

// out(rows x cols) = A(rows x k) * B(k x cols), row-major.
void matmul(const uint8_t* A, const uint8_t* B, uint8_t* out, int rows, int k,
            int cols) {
  std::memset(out, 0, static_cast<size_t>(rows) * cols);
  for (int i = 0; i < rows; ++i) {
    for (int j = 0; j < k; ++j) {
      uint8_t a = A[i * k + j];
      if (a == 0) continue;
      int la = T.log[a];
      const uint8_t* brow = B + static_cast<size_t>(j) * cols;
      uint8_t* orow = out + static_cast<size_t>(i) * cols;
      for (int c = 0; c < cols; ++c) {
        uint8_t b = brow[c];
        if (b) orow[c] ^= T.exp[la + T.log[b]];
      }
    }
  }
}

// Gauss-Jordan inverse; returns 0 on success, -1 if singular.
int invert(const uint8_t* M, uint8_t* out, int n) {
  std::vector<uint8_t> aug(static_cast<size_t>(n) * 2 * n, 0);
  for (int i = 0; i < n; ++i) {
    std::memcpy(&aug[static_cast<size_t>(i) * 2 * n], M + static_cast<size_t>(i) * n, n);
    aug[static_cast<size_t>(i) * 2 * n + n + i] = 1;
  }
  for (int col = 0; col < n; ++col) {
    int piv = -1;
    for (int r = col; r < n; ++r)
      if (aug[static_cast<size_t>(r) * 2 * n + col]) { piv = r; break; }
    if (piv < 0) return -1;
    if (piv != col)
      for (int c = 0; c < 2 * n; ++c)
        std::swap(aug[static_cast<size_t>(col) * 2 * n + c],
                  aug[static_cast<size_t>(piv) * 2 * n + c]);
    uint8_t inv = gf_inv(aug[static_cast<size_t>(col) * 2 * n + col]);
    for (int c = 0; c < 2 * n; ++c)
      aug[static_cast<size_t>(col) * 2 * n + c] =
          gf_mul(aug[static_cast<size_t>(col) * 2 * n + c], inv);
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      uint8_t f = aug[static_cast<size_t>(r) * 2 * n + col];
      if (!f) continue;
      for (int c = 0; c < 2 * n; ++c)
        aug[static_cast<size_t>(r) * 2 * n + c] ^=
            gf_mul(f, aug[static_cast<size_t>(col) * 2 * n + c]);
    }
  }
  for (int i = 0; i < n; ++i)
    std::memcpy(out + static_cast<size_t>(i) * n,
                &aug[static_cast<size_t>(i) * 2 * n + n], n);
  return 0;
}

uint8_t gf_pow(uint8_t a, int e) {
  if (e == 0) return 1;
  if (a == 0) return 0;
  long long l = (static_cast<long long>(T.log[a]) * e) % 255;
  return T.exp[l];
}

// ---- SIMD constant-matrix apply -------------------------------------------
//
// The encode/decode matrices are tiny and fixed per (n, f) while the shard
// byte count is MB-scale, so the profitable shape is "constant scalar times
// long byte vector".  Each constant c gets a pair of 16-entry nibble tables
//   TLO[x] = c * x          (x in 0..15)
//   THI[x] = c * (x << 4)
// and gf_mul(c, b) == TLO[b & 15] ^ THI[b >> 4] — two pshufb lookups per 32
// bytes on AVX2 (the ISA-L trick).  Columns are walked in L2-sized tiles so
// every B row of a tile stays cache-hot across the k accumulation passes.

void build_nibble_tables(uint8_t c, uint8_t* tlo, uint8_t* thi) {
  for (int x = 0; x < 16; ++x) {
    tlo[x] = gf_mul(c, static_cast<uint8_t>(x));
    thi[x] = gf_mul(c, static_cast<uint8_t>(x << 4));
  }
}

// out(rows x cols) = A(rows x k) * B(k x cols), row-major; A is the small
// constant matrix, B/out are shard-length rows.
void matmul_simd(const uint8_t* A, const uint8_t* B, uint8_t* out, int rows,
                 int k, int64_t cols) {
  // nibble tables for every (row, j) constant, built once per call: the
  // matrix is rows*k bytes, the data is rows*k*cols — negligible setup.
  std::vector<uint8_t> tabs(static_cast<size_t>(rows) * k * 32);
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < k; ++j)
      build_nibble_tables(A[i * k + j],
                          &tabs[(static_cast<size_t>(i) * k + j) * 32],
                          &tabs[(static_cast<size_t>(i) * k + j) * 32 + 16]);
  const int64_t kTile = 1 << 16;  // 64 KiB column tile: k rows fit in L2
  for (int64_t t0 = 0; t0 < cols; t0 += kTile) {
    int64_t tlen = cols - t0 < kTile ? cols - t0 : kTile;
    for (int i = 0; i < rows; ++i) {
      uint8_t* orow = out + static_cast<size_t>(i) * cols + t0;
      std::memset(orow, 0, static_cast<size_t>(tlen));
      for (int j = 0; j < k; ++j) {
        const uint8_t a = A[i * k + j];
        if (a == 0) continue;
        const uint8_t* brow = B + static_cast<size_t>(j) * cols + t0;
        const uint8_t* tab = &tabs[(static_cast<size_t>(i) * k + j) * 32];
        int64_t c = 0;
#ifdef __AVX2__
        const __m128i tlo128 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(tab));
        const __m128i thi128 = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(tab + 16));
        const __m256i tlo = _mm256_broadcastsi128_si256(tlo128);
        const __m256i thi = _mm256_broadcastsi128_si256(thi128);
        const __m256i mask = _mm256_set1_epi8(0x0F);
        for (; c + 32 <= tlen; c += 32) {
          __m256i x = _mm256_loadu_si256(
              reinterpret_cast<const __m256i*>(brow + c));
          __m256i lo = _mm256_and_si256(x, mask);
          __m256i hi = _mm256_and_si256(_mm256_srli_epi64(x, 4), mask);
          __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(tlo, lo),
                                          _mm256_shuffle_epi8(thi, hi));
          __m256i acc = _mm256_loadu_si256(
              reinterpret_cast<const __m256i*>(orow + c));
          _mm256_storeu_si256(reinterpret_cast<__m256i*>(orow + c),
                              _mm256_xor_si256(acc, prod));
        }
#endif
        const uint8_t* tlo8 = tab;
        const uint8_t* thi8 = tab + 16;
        for (; c < tlen; ++c)
          orow[c] ^= static_cast<uint8_t>(tlo8[brow[c] & 0x0F] ^
                                          thi8[brow[c] >> 4]);
      }
    }
  }
}

}  // namespace

extern "C" {

void hbbft_gf_mul_bytes(const uint8_t* a, const uint8_t* b, uint8_t* out,
                        int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = gf_mul(a[i], b[i]);
}

void hbbft_gf_matmul(const uint8_t* A, const uint8_t* B, uint8_t* out,
                     int rows, int k, int cols) {
  matmul(A, B, out, rows, k, cols);
}

// SIMD apply of a CALLER-CACHED matrix (encode parity block or decode
// inverse): unlike hbbft_rs_encode this never rebuilds the Vandermonde
// system per call, which is what made the old per-call path O(matrix) on
// top of O(bytes).  out must not alias B (parity tail vs data head of one
// allocation is fine).
void hbbft_gf_matmul_simd(const uint8_t* A, const uint8_t* B, uint8_t* out,
                          int rows, int k, int64_t cols) {
  matmul_simd(A, B, out, rows, k, cols);
}

int hbbft_gf_invert(const uint8_t* M, uint8_t* out, int n) {
  return invert(M, out, n);
}

// Systematic Vandermonde encode matrix, (total x data) row-major into out.
int hbbft_rs_matrix(int data, int total, uint8_t* out) {
  if (data < 1 || total < data || total > 256) return -1;
  std::vector<uint8_t> V(static_cast<size_t>(total) * data);
  for (int r = 0; r < total; ++r)
    for (int c = 0; c < data; ++c)
      V[static_cast<size_t>(r) * data + c] = gf_pow(static_cast<uint8_t>(r), c);
  std::vector<uint8_t> topinv(static_cast<size_t>(data) * data);
  if (invert(V.data(), topinv.data(), data) != 0) return -1;
  matmul(V.data(), topinv.data(), out, total, data, data);
  return 0;
}

// shards: (total x shard_len) row-major with data rows filled; fills parity.
int hbbft_rs_encode(int data, int total, int64_t shard_len, uint8_t* shards) {
  std::vector<uint8_t> M(static_cast<size_t>(total) * data);
  if (hbbft_rs_matrix(data, total, M.data()) != 0) return -1;
  matmul(M.data() + static_cast<size_t>(data) * data, shards,
         shards + static_cast<size_t>(data) * shard_len, total - data, data,
         static_cast<int>(shard_len));
  return 0;
}

// present: total flags; shards: (total x shard_len) with absent rows ignored.
// Reconstructs ALL rows in place. Returns 0 ok, -1 too few, -2 bad args.
int hbbft_rs_reconstruct(int data, int total, int64_t shard_len,
                         uint8_t* shards, const uint8_t* present) {
  if (data < 1 || total < data) return -2;
  std::vector<int> use;
  for (int i = 0; i < total && static_cast<int>(use.size()) < data; ++i)
    if (present[i]) use.push_back(i);
  if (static_cast<int>(use.size()) < data) return -1;
  std::vector<uint8_t> M(static_cast<size_t>(total) * data);
  if (hbbft_rs_matrix(data, total, M.data()) != 0) return -2;
  std::vector<uint8_t> sub(static_cast<size_t>(data) * data);
  std::vector<uint8_t> subshards(static_cast<size_t>(data) * shard_len);
  for (int i = 0; i < data; ++i) {
    std::memcpy(&sub[static_cast<size_t>(i) * data],
                &M[static_cast<size_t>(use[i]) * data], data);
    std::memcpy(&subshards[static_cast<size_t>(i) * shard_len],
                shards + static_cast<size_t>(use[i]) * shard_len, shard_len);
  }
  std::vector<uint8_t> dec(static_cast<size_t>(data) * data);
  if (invert(sub.data(), dec.data(), data) != 0) return -2;
  std::vector<uint8_t> recovered(static_cast<size_t>(data) * shard_len);
  matmul(dec.data(), subshards.data(), recovered.data(), data, data,
         static_cast<int>(shard_len));
  std::memcpy(shards, recovered.data(), recovered.size());
  // re-derive parity rows
  matmul(M.data() + static_cast<size_t>(data) * data, shards,
         shards + static_cast<size_t>(data) * shard_len, total - data, data,
         static_cast<int>(shard_len));
  return 0;
}

}  // extern "C"
