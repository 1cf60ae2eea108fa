// Lazy BLS12-381 field multiply for Hopper (sm_90a): one thread per row.
//
// Replaces: hbbft_tpu/ops/pallas_fp.py :: fp_mul_lazy_pallas (body
// _mul_kernel → mul_lazy_cols), the same function that the JAX ladders run
// XLA-lowered as ops/fp381.py :: fp_mul_lazy.  Inputs and output are int32
// (NL=30, R) columns of 13-bit digits: limb i of row r at [i*R + r].
//
// What bounds it on this card: per row it moves 360 bytes (two 30-limb
// inputs, one 30-limb output) and does ~5k int32 operations (900
// multiply-adds of the convolution, 930 of the fold, the carry passes), so
// at the ladder's few hundred rows the whole launch is tens of
// nanoseconds of work against several microseconds of launch latency: it
// is launch-bound.  At large R it would be bound by the int32 pipes, not
// by memory (~14 ops per byte).
//
// Design: thread r keeps b's 30 digits and the 61-digit product in
// registers, reads a[i*R + r] / b[i*R + r] coalesced across the warp (the
// column layout), and runs the reference's exact sequence — convolution,
// 3 rough carries over 61 digits, fold of digits 30..60 against the 31
// residue rows, 4 squeeze rounds through row 0 — so the output is
// digit-exact with the plain version.  All products are < 2^26 and every
// digit sum stays < 2^31, so int32 never wraps.  The (31, 30) fold table
// is staged once per block in shared memory; all threads of a warp read
// the same word at the same time, which shared memory broadcasts.
// Keeping the ladder's limbs in registers across field operations (a
// whole-ladder kernel) is the redesign this launch-bound shape asks for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 30;
constexpr int NT = 2 * NL + 1;  // product digits
constexpr int kBits = 13;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr int kThreads = 64;

// three rough carry passes over n digits; the top digit's carry is
// dropped, exactly as the reference's shift-by-one does
template <int N>
__device__ __forceinline__ void carry_rough(int32_t (&t)[N]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    int32_t carry = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int32_t c = t[i] >> kBits;
      t[i] = (t[i] & kMask) + carry;
      carry = c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fp_mul_lazy_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b,
                   const int32_t* __restrict__ fold,
                   int32_t* __restrict__ out, int R) {
  __shared__ int32_t sfold[(NL + 1) * NL];
  for (int i = threadIdx.x; i < (NL + 1) * NL; i += blockDim.x) sfold[i] = fold[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  int32_t bv[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) bv[j] = b[j * R + r];

  int32_t t[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t ai = a[i * R + r];
#pragma unroll
    for (int j = 0; j < NL; ++j) t[i + j] += ai * bv[j];
  }
  carry_rough(t);

  // fold digits NL..2NL against rows 2^(13 j) mod p, then one spare digit
  int32_t acc[NL + 1];
#pragma unroll
  for (int i = 0; i < NL; ++i) acc[i] = t[i];
  acc[NL] = 0;
#pragma unroll
  for (int j = 0; j <= NL; ++j) {
    const int32_t hi = t[NL + j];
#pragma unroll
    for (int i = 0; i < NL; ++i) acc[i] += hi * sfold[j * NL + i];
  }

  // squeeze: rough-carry, then fold the top digit back through row 0
  carry_rough(acc);
#pragma unroll
  for (int round = 0; round < 4; ++round) {
    const int32_t top = acc[NL];
    acc[NL] = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) acc[i] += top * sfold[i];
    carry_rough(acc);
  }

#pragma unroll
  for (int i = 0; i < NL; ++i) out[i * R + r] = acc[i];
}

}  // namespace

extern "C" int hb_fp_mul_lazy(const void* a, const void* b, const void* fold,
                              void* out, int R, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  fp_mul_lazy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)fold,
      (int32_t*)out, R);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
