// Batched SHA3-256 for Hopper (sm_90a): one thread per message.
//
// Replaces: hbbft_tpu/ops/keccak.py :: keccak_f1600 + sha3_256 (the
// XLA-lowered permutation on uint32 hi/lo lane pairs that the Merkle
// commit, the proof checks and the decode-side root check run on).
//
// What bounds it on this card: bytes.  Each message byte is read once and
// each digest written once; the 24-round permutation costs ~3k 64-bit ops
// per 136-byte block, which the SMs retire far faster than HBM delivers
// the block.  At the epoch's shapes (4 096 leaves of ~2.9 KB, then 64-byte
// interior nodes) the batch is a few thousand threads, so in practice the
// kernel is latency-bound: a thread walks its message serially.
//
// Design: native uint64 lanes in registers (the TPU needed hi/lo halves),
// the whole absorb loop, the 0x06/0x80 padding at rate 136 and the 32-byte
// squeeze in one thread; no shared memory.  Each thread reads its own row
// byte by byte, so a warp's loads are strided by the message length (not
// coalesced); the rows are read front to back, so L1/L2 lines are reused
// by the next loads of the same thread.  Staging rows through shared
// memory for coalesced loads is left to a later change.  Byte-exact with
// hashlib.sha3_256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRate = 136;
constexpr int kRateLanes = kRate / 8;

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

// keccak-f[1600] on st[x + 5y]; rho offsets and the pi lane walk are the
// spec's, written out so every index is a compile-time constant and the
// state stays in registers.
__device__ __forceinline__ void keccak_f1600(uint64_t st[25]) {
  constexpr int kRot[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  constexpr int kPi[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                           15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t bc[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = bc[(x + 4) % 5] ^ rotl64(bc[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) st[y + x] ^= d;
    }
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int j = kPi[i];
      const uint64_t keep = st[j];
      st[j] = rotl64(t, kRot[i]);
      t = keep;
    }
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint64_t row[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) row[x] = st[y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        st[y + x] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5]);
    }
    st[0] ^= kRoundConstants[round];
  }
}

__global__ void sha3_256_kernel(const uint8_t* __restrict__ msgs,
                                int64_t n_msgs, int64_t len,
                                uint8_t* __restrict__ out) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n_msgs) return;
  const uint8_t* m = msgs + idx * len;
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;

  const int64_t full = len / kRate;
  for (int64_t b = 0; b < full; ++b) {
    const uint8_t* blk = m + b * kRate;
#pragma unroll
    for (int l = 0; l < kRateLanes; ++l) {
      uint64_t w = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) w |= (uint64_t)blk[l * 8 + k] << (8 * k);
      st[l] ^= w;
    }
    keccak_f1600(st);
  }
  // last (partial, possibly empty) block with the FIPS-202 padding
  const int rem = (int)(len - full * kRate);
  const uint8_t* blk = m + full * kRate;
#pragma unroll
  for (int l = 0; l < kRateLanes; ++l) {
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int pos = l * 8 + k;
      uint64_t byte = pos < rem ? blk[pos] : 0;
      if (pos == rem) byte ^= 0x06;
      if (pos == kRate - 1) byte ^= 0x80;
      w |= byte << (8 * k);
    }
    st[l] ^= w;
  }
  keccak_f1600(st);

  uint8_t* o = out + idx * 32;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[l * 8 + k] = (uint8_t)(st[l] >> (8 * k));
  }
}

}  // namespace

extern "C" int hb_sha3_256(const void* msgs, int64_t n_msgs, int64_t len,
                           void* out, void* stream) {
  constexpr int kThreads = 128;
  const int64_t blocks = (n_msgs + kThreads - 1) / kThreads;
  sha3_256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msgs, n_msgs, len, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
