// Batched SHA3-256 for Hopper (sm_90a): two threads per message, each
// holding one 32-bit half of every 64-bit lane.
//
// Replaces: hbbft_tpu/ops/keccak.py :: keccak_f1600 + sha3_256 (the
// XLA-lowered permutation on uint32 hi/lo lane pairs that the Merkle
// commit, the proof checks and the decode-side root check run on).
//
// What bounds it on this card: at the epoch's shapes (4 096 leaves of
// 2 924 B, 22 blocks each; then 2 048 interior pairs of 64 B) the batch is
// a few thousand messages, and each message is a serial chain of
// permutations, so the kernel is bound by the latency of one message's
// instruction stream, far from HBM's rate (12 MB at 3.35 TB/s is 3.6 µs).
// A round is four dependent phases (θ's parities, the rot-1 exchange and
// θ's XORs, the ρ exchange and rotations, χ), and an SM sub-partition
// retires a warp's int32 instruction every 2 clocks (16 lanes a clock).
//
// Design: the TPU reference's hi/lo form, split over a pair of neighbouring
// lanes: lane 2m holds the low halves of message m's 25 lanes, lane 2m+1
// the high halves.  A 64-bit rotation by r is then one exchange with the
// partner (__shfl_xor 1) and one funnel shift, the same instruction on both
// lanes (for r ≥ 32 the operands swap); θ, χ and ι are local.  Per round a
// thread issues 29 shuffles (5 for θ's rot-1, 24 for ρ) beside ~100 int32
// instructions.  Two threads per message double the warps in flight (the
// epoch's 4 096 leaves: 256 warps instead of 128) and halve each thread's
// serial stream.  Blocks of one warp (16 messages) spread the batch over
// all SMs.
//
// Loads: each absorb block of 136 bytes is staged in shared memory for the
// block's messages at once, word by word, neighbouring threads on
// neighbouring words (cp.async, 4 bytes, when the length and the base are
// multiples of 4; byte by byte otherwise and for the padded tail),
// double-buffered so that block b+1's copy overlaps block b's permutation.
// The FIPS-202 padding (0x06 … 0x80 at rate 136) is applied while staging.
// Byte-exact with hashlib.sha3_256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRate = 136;
constexpr int kRateWords = kRate / 4;  // 34 words of 32 bits
constexpr int kMsgs = 16;              // messages per block (one warp)
constexpr int kThreads = 2 * kMsgs;
constexpr unsigned kFull = 0xffffffffu;

// the round constants as (low, high) 32-bit halves
__constant__ uint32_t kRoundConstants[24][2] = {
    {0x00000001u, 0x00000000u}, {0x00008082u, 0x00000000u}, {0x0000808au, 0x80000000u},
    {0x80008000u, 0x80000000u}, {0x0000808bu, 0x00000000u}, {0x80000001u, 0x00000000u},
    {0x80008081u, 0x80000000u}, {0x00008009u, 0x80000000u}, {0x0000008au, 0x00000000u},
    {0x00000088u, 0x00000000u}, {0x80008009u, 0x00000000u}, {0x8000000au, 0x00000000u},
    {0x8000808bu, 0x00000000u}, {0x0000008bu, 0x80000000u}, {0x00008089u, 0x80000000u},
    {0x00008003u, 0x80000000u}, {0x00008002u, 0x80000000u}, {0x00000080u, 0x80000000u},
    {0x0000800au, 0x00000000u}, {0x8000000au, 0x80000000u}, {0x80008081u, 0x80000000u},
    {0x00008080u, 0x80000000u}, {0x80000001u, 0x00000000u}, {0x80008008u, 0x80000000u},
};

// This lane's half of rotl64(x, r), given its own half v of x: the partner
// lane holds the other half.  For 0 < r < 32 both halves are
// (v << r) | (u >> (32 - r)); for r ≥ 32 the halves swap first.  r is the
// same on every lane (a compile-time constant after unrolling).
__device__ __forceinline__ uint32_t rotl_half(uint32_t v, int r) {
  if (r == 0) return v;
  const uint32_t u = __shfl_xor_sync(kFull, v, 1);
  return r < 32 ? __funnelshift_l(u, v, r) : __funnelshift_l(v, u, r - 32);
}

// keccak-f[1600] on this lane's halves st[x + 5y]; the rho offsets and the
// pi lane walk are the spec's, written out so every index and rotation is a
// compile-time constant and the state stays in registers.
__device__ __forceinline__ void keccak_f1600(uint32_t st[25], int h) {
  constexpr int kRot[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  constexpr int kPi[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                           15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint32_t bc[5], rot1[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) rot1[x] = rotl_half(bc[x], 1);
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint32_t d = bc[(x + 4) % 5] ^ rot1[(x + 1) % 5];
#pragma unroll
      for (int y = 0; y < 25; y += 5) st[y + x] ^= d;
    }
    uint32_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int j = kPi[i];
      const uint32_t keep = st[j];
      st[j] = rotl_half(t, kRot[i]);
      t = keep;
    }
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint32_t row[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) row[x] = st[y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        st[y + x] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5]);
    }
    st[0] ^= kRoundConstants[round][h];
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Stage absorb block b of the block's messages into buf[kMsgs][kRateWords],
// padded: byte k of a message's padded stream is msg[k] (k < len) or 0,
// with 0x06 at k == len and 0x80 at the last byte of the last block.
__device__ __forceinline__ void stage(uint32_t (*buf)[kRateWords], const uint8_t* __restrict__ msgs,
                                      int64_t first, int64_t n_msgs, int64_t len, int64_t b,
                                      int64_t nblocks) {
  const bool words = (len & 3) == 0 && (reinterpret_cast<uintptr_t>(msgs) & 3) == 0;
  const int64_t last = kRate * nblocks - 1;
  for (int q = threadIdx.x; q < kMsgs * kRateWords; q += kThreads) {
    const int mm = q / kRateWords, w = q - mm * kRateWords;
    const int64_t m = first + mm;
    if (m >= n_msgs) continue;
    const uint8_t* row = msgs + m * len;
    const int64_t k0 = kRate * b + 4 * w;
    if (words && k0 + 4 <= len) {
      cp_async4(&buf[mm][w], row + k0);
    } else {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t pos = k0 + k;
        uint32_t byte = pos < len ? row[pos] : 0u;
        if (pos == len) byte ^= 0x06u;
        if (pos == last) byte ^= 0x80u;
        word |= byte << (8 * k);
      }
      buf[mm][w] = word;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sha3_256_kernel(const uint8_t* __restrict__ msgs, int64_t n_msgs, int64_t len,
                uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t buf[2][kMsgs][kRateWords];
  const int mm = threadIdx.x >> 1, h = threadIdx.x & 1;  // h: the high half
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kMsgs;
  const int64_t m = first + mm;
  const int64_t nblocks = len / kRate + 1;
  uint32_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;

  stage(buf[0], msgs, first, n_msgs, len, 0, nblocks);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int64_t b = 0; b < nblocks; ++b) {
    cp_async_wait_all();
    __syncthreads();  // block b staged; every thread done with block b-1
    if (b + 1 < nblocks) {
      stage(buf[(b + 1) & 1], msgs, first, n_msgs, len, b + 1, nblocks);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    const uint32_t* blk = buf[b & 1][mm];
#pragma unroll
    for (int l = 0; l < kRate / 8; ++l) st[l] ^= blk[2 * l + h];
    keccak_f1600(st, h);  // every thread, so the pair exchanges stay uniform
  }

  if (m < n_msgs) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out + m * 32);
#pragma unroll
    for (int l = 0; l < 4; ++l) o[2 * l + h] = st[l];
  }
}

}  // namespace

extern "C" int hb_sha3_256(const void* msgs, int64_t n_msgs, int64_t len,
                           void* out, void* stream) {
  const int64_t blocks = (n_msgs + kMsgs - 1) / kMsgs;
  sha3_256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msgs, n_msgs, len, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
