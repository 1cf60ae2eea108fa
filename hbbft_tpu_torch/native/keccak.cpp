// Keccak-f[1600] / SHA3-256 CPU oracle (C ABI, loaded via ctypes).
//
// Ground truth for hbbft_tpu/ops/keccak.py (the reference hashes Merkle
// leaves and the common-coin signature with SHA3 via `tiny-keccak`;
// src/broadcast/merkle.rs). Constants derived from the FIPS-202 LFSR, same
// as the jnp implementation, so a transcription error cannot hide in both.

#include <cstdint>
#include <cstring>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

uint64_t kRC[24];
int kRot[5][5];  // rot[x][y]
bool kInit = false;

int rc_bit(int t) {
  t %= 255;
  if (t == 0) return 1;
  int R = 1;
  for (int i = 1; i <= t; ++i) {
    R <<= 1;
    if (R & 0x100) R ^= 0x171;
  }
  return R & 1;
}

void init_tables() {
  if (kInit) return;
  for (int i = 0; i < 24; ++i) {
    uint64_t rc = 0;
    for (int j = 0; j < 7; ++j)
      if (rc_bit(7 * i + j)) rc |= 1ULL << ((1 << j) - 1);
    kRC[i] = rc;
  }
  int x = 1, y = 0;
  kRot[0][0] = 0;
  for (int t = 0; t < 24; ++t) {
    kRot[x][y] = ((t + 1) * (t + 2) / 2) % 64;
    int nx = y, ny = (2 * x + 3 * y) % 5;
    x = nx;
    y = ny;
  }
  kInit = true;
}

inline uint64_t rotl(uint64_t v, int s) {
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

// state[5*y + x] = A[x][y]
void keccak_f(uint64_t* s) {
  init_tables();
  uint64_t B[25], C[5], D[5];
  for (int rnd = 0; rnd < 24; ++rnd) {
    for (int x = 0; x < 5; ++x)
      C[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
    for (int x = 0; x < 5; ++x)
      D[x] = C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) s[5 * y + x] ^= D[x];
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) {
        int nx = y, ny = (2 * x + 3 * y) % 5;
        B[5 * ny + nx] = rotl(s[5 * y + x], kRot[x][y]);
      }
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        s[5 * y + x] =
            B[5 * y + x] ^ (~B[5 * y + (x + 1) % 5] & B[5 * y + (x + 2) % 5]);
    s[0] ^= kRC[rnd];
  }
}

#ifdef __AVX2__
// ---- 4-way parallel keccak ------------------------------------------------
//
// One 64-bit element of a __m256i per stream: four equal-length messages run
// the permutation in lockstep (the Merkle leaf batch is exactly this shape —
// every RBC shard has the same length).  Same table derivation as the scalar
// path, so the two cannot diverge without a test catching it.

// Immediate-count lane rotate: the variable-count form (vpsllq with an xmm
// count) costs an extra move per rotation and defeats constant folding, so
// the rho step below is unrolled with literal offsets (the standard rho/pi
// walk; the scalar path still derives its table from the LFSR, and the
// cross-check tests pin the two together).
#if defined(__AVX512VL__)
// vprolq: single-instruction lane rotate when AVX-512VL is present
#define ROL4(v, s) _mm256_rol_epi64((v), (s))
// vpternlogq: any 3-input boolean in one instruction.  0x96 = a^b^c
// (theta's 5-way column xor becomes two ops), 0xD2 = a^(~b&c) (the
// whole chi row update in one op instead of xor+andnot)
#define XOR3(a, b, c) _mm256_ternarylogic_epi64((a), (b), (c), 0x96)
#define CHI4(a, b, c) _mm256_ternarylogic_epi64((a), (b), (c), 0xD2)
#else
#define ROL4(v, s)                                            \
  _mm256_or_si256(_mm256_slli_epi64((v), (s)),                \
                  _mm256_srli_epi64((v), 64 - (s)))
#define XOR3(a, b, c) \
  _mm256_xor_si256(_mm256_xor_si256((a), (b)), (c))
#define CHI4(a, b, c) \
  _mm256_xor_si256((a), _mm256_andnot_si256((b), (c)))
#endif

void keccak_f4(__m256i* st) {
  init_tables();
  __m256i bc[5], t, u;
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta
    for (int i = 0; i < 5; ++i)
      bc[i] = XOR3(XOR3(st[i], st[i + 5], st[i + 10]), st[i + 15],
                   st[i + 20]);
    for (int i = 0; i < 5; ++i) {
      t = _mm256_xor_si256(bc[(i + 4) % 5], ROL4(bc[(i + 1) % 5], 1));
      for (int j = 0; j < 25; j += 5)
        st[j + i] = _mm256_xor_si256(st[j + i], t);
    }
    // rho + pi (unrolled with immediate rotation counts)
    t = st[1];
#define RP(dst, rot) u = st[dst]; st[dst] = ROL4(t, rot); t = u;
    RP(10, 1)  RP(7, 3)   RP(11, 6)  RP(17, 10) RP(18, 15) RP(3, 21)
    RP(5, 28)  RP(16, 36) RP(8, 45)  RP(21, 55) RP(24, 2)  RP(4, 14)
    RP(15, 27) RP(23, 41) RP(19, 56) RP(13, 8)  RP(12, 25) RP(2, 43)
    RP(20, 62) RP(14, 18) RP(22, 39) RP(9, 61)  RP(6, 20)  RP(1, 44)
#undef RP
    // chi
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = CHI4(bc[i], bc[(i + 1) % 5], bc[(i + 2) % 5]);
    }
    // iota
    st[0] = _mm256_xor_si256(
        st[0], _mm256_set1_epi64x(static_cast<long long>(kRC[rnd])));
  }
}

// Four equal-length messages -> four 32-byte digests (out stride 32).
void sha3_256_x4(const uint8_t* msgs[4], int64_t len, uint8_t* out) {
  const int rate = 136;
  __m256i s[25];
  for (int i = 0; i < 25; ++i) s[i] = _mm256_setzero_si256();
  int64_t off = 0;
  uint64_t l[4];
  while (len - off >= rate) {
    for (int i = 0; i < rate / 8; ++i) {
      for (int t = 0; t < 4; ++t) std::memcpy(&l[t], msgs[t] + off + 8 * i, 8);
      s[i] = _mm256_xor_si256(
          s[i], _mm256_set_epi64x(static_cast<long long>(l[3]),
                                  static_cast<long long>(l[2]),
                                  static_cast<long long>(l[1]),
                                  static_cast<long long>(l[0])));
    }
    keccak_f4(s);
    off += rate;
  }
  uint8_t block[4][136];
  for (int t = 0; t < 4; ++t) {
    std::memset(block[t], 0, rate);
    std::memcpy(block[t], msgs[t] + off, len - off);
    block[t][len - off] ^= 0x06;
    block[t][rate - 1] ^= 0x80;
  }
  for (int i = 0; i < rate / 8; ++i) {
    for (int t = 0; t < 4; ++t) std::memcpy(&l[t], block[t] + 8 * i, 8);
    s[i] = _mm256_xor_si256(
        s[i], _mm256_set_epi64x(static_cast<long long>(l[3]),
                                static_cast<long long>(l[2]),
                                static_cast<long long>(l[1]),
                                static_cast<long long>(l[0])));
  }
  keccak_f4(s);
  alignas(32) uint64_t lane[4];
  for (int w = 0; w < 4; ++w) {
    _mm256_store_si256(reinterpret_cast<__m256i*>(lane), s[w]);
    for (int t = 0; t < 4; ++t) std::memcpy(out + t * 32 + 8 * w, &lane[t], 8);
  }
}
#endif  // __AVX2__

}  // namespace

extern "C" {

void hbbft_keccak_f1600(uint64_t* state) { keccak_f(state); }

void hbbft_sha3_256(const uint8_t* data, int64_t len, uint8_t* out) {
  const int rate = 136;
  uint64_t s[25];
  std::memset(s, 0, sizeof(s));
  int64_t off = 0;
  while (len - off >= rate) {
    for (int i = 0; i < rate / 8; ++i) {
      uint64_t lane;
      std::memcpy(&lane, data + off + 8 * i, 8);  // little-endian host assumed
      s[i] ^= lane;
    }
    keccak_f(s);
    off += rate;
  }
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data + off, len - off);
  block[len - off] ^= 0x06;
  block[rate - 1] ^= 0x80;
  for (int i = 0; i < rate / 8; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    s[i] ^= lane;
  }
  keccak_f(s);
  std::memcpy(out, s, 32);
}

// Batched: n messages, each msg_len bytes, contiguous.  Groups of four run
// the 4-way AVX2 permutation; the remainder falls back to the scalar path.
void hbbft_sha3_256_batch(const uint8_t* data, int64_t n, int64_t msg_len,
                          uint8_t* out) {
  int64_t i = 0;
#ifdef __AVX2__
  for (; i + 4 <= n; i += 4) {
    const uint8_t* msgs[4] = {
        data + i * msg_len, data + (i + 1) * msg_len,
        data + (i + 2) * msg_len, data + (i + 3) * msg_len};
    sha3_256_x4(msgs, msg_len, out + i * 32);
  }
#endif
  for (; i < n; ++i)
    hbbft_sha3_256(data + i * msg_len, msg_len, out + i * 32);
}

}  // extern "C"
