// The lazy BLS12-381 field (Fp, Fp2) as warp-cooperative device functions.
//
// Replaces, inside the kernels that include it: hbbft_tpu/ops/pallas_fp.py
// :: mul_lazy_cols (the body of the Pallas kernel fp_mul_lazy_pallas) and
// the lazy add/sub/neg and Fp2 products of hbbft_tpu/ops/fp381.py, in the
// port's order (hbbft_tpu_torch/ops/fp381.py).  Every function runs the
// plain version's exact sequence, so every digit matches.
//
// Layout: one warp holds one field element, one 13-bit digit a lane.  Lane
// l < 30 holds digit l, lane 30 the squeeze's spare digit (0 between
// operations) and lane 31 nothing (always 0).  A product's 61 digits sit two
// a lane: lane l (0..30) holds t[l] and t[l + 31] (t[61], on lane 30, is
// always 0).
//
// Carries: the plain rough carry is a parallel pass (every carry comes from
// the old digits, the carry out of the top digit is dropped), so a pass is
// one __shfl_up_sync and the top lane's carry is discarded.
//
// int32 never wraps: every digit of an operand lies in [0, 2^13], so every
// product is < 2^26 and every digit sum (30 products in the convolution,
// 31 in the fold) stays < 2^31, as in the reference.
//
// The residue rows 2^(13 j) mod p (j = 30..60) and the sub constant are
// staged once per block in shared memory, one column per lane
// (stage_consts); each lane reads only its own column, so there are no bank
// conflicts.  Every 32 lanes of a warp call each function together (the
// shuffles use the full mask); callers keep every branch warp-uniform.
//
// The product and the squeeze are out-of-line functions: a ladder step
// calls them 48 (G1) to 207 (G2) times, and inlined they would make a loop
// body of several hundred KB that no instruction cache holds.

#pragma once

#include <cstdint>

namespace hb {

constexpr int NL = 30;
constexpr int kBits = 13;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr unsigned kFull = 0xffffffffu;

// fold[j][l]: digit l of 2^(13 (NL + j)) mod p; sub[l]: digit l of the sub
// constant (-2 (2^390 - 1) mod p).  Columns 30 and 31 are 0.
__shared__ int32_t s_fold[NL + 1][32];
__shared__ int32_t s_subc[32];

// Stage the (NL + 1, NL) residue rows and the NL-digit sub constant
// (nullptr: zeros) from device memory; every thread of the block calls it.
__device__ __forceinline__ void stage_consts(const int32_t* __restrict__ fold,
                                             const int32_t* __restrict__ subc) {
  for (int i = threadIdx.x; i < (NL + 1) * 32; i += blockDim.x) {
    const int j = i >> 5, l = i & 31;
    s_fold[j][l] = l < NL ? fold[j * NL + l] : 0;
  }
  for (int l = threadIdx.x; l < 32; l += blockDim.x) {
    s_subc[l] = (subc != nullptr && l < NL) ? subc[l] : 0;
  }
  __syncthreads();
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Three rough carry passes over the 31 digits on lanes 0..30; the carry out
// of digit 30 is dropped (lane 31 holds no digit).
__device__ __forceinline__ int32_t carry31(int32_t x, int l) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int32_t c = __shfl_up_sync(kFull, x >> kBits, 1);
    x = (x & kMask) + (l == 0 ? 0 : c);
    if (l == 31) x = 0;
  }
  return x;
}

// Digits < 2^31 on lanes 0..29 (lanes 30, 31: 0) → lazy digits: rough
// carry, then fold the spare digit back through row 0 four times.  The
// spare digit left by the last carry is dropped, as the plain version
// returns only the low NL digits.
__device__ __noinline__ int32_t fp_squeeze(int32_t x) {
  const int l = lane_id();
  x = carry31(x, l);
#pragma unroll
  for (int round = 0; round < 4; ++round) {
    const int32_t top = __shfl_sync(kFull, x, NL);
    x = l < NL ? x + top * s_fold[0][l] : 0;
    x = carry31(x, l);
  }
  return l < NL ? x : 0;
}

// a·b (mod p), lazy: the 30×30 convolution into 61 digits, 3 rough carries,
// the fold of digits 30..60 against the 31 residue rows, the squeeze.
__device__ __noinline__ int32_t fp_mul(int32_t a, int32_t b) {
  const int l = lane_id();
  // convolution: at step i lane l takes a[i]·b[(l − i) mod 31] (b's digit
  // 30 is 0) into t[l] when i ≤ l, else into t[l + 31]
  int32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t ai = __shfl_sync(kFull, a, i);
    const int src = l >= i ? l - i : l - i + 31;
    const int32_t p = ai * __shfl_sync(kFull, b, src);
    if (i <= l) lo += p; else hi += p;
  }
  if (l == 31) lo = 0;
  // 3 rough carries over t[0..60]; t[30]'s carry goes to t[31] (lane 0's
  // hi), t[60]'s is dropped
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int32_t clo = lo >> kBits, chi = hi >> kBits;
    const int32_t up_lo = __shfl_up_sync(kFull, clo, 1);
    const int32_t up_hi = __shfl_up_sync(kFull, chi, 1);
    const int32_t c30 = __shfl_sync(kFull, clo, NL);
    lo = (lo & kMask) + (l == 0 ? 0 : up_lo);
    hi = (hi & kMask) + (l == 0 ? c30 : up_hi);
    if (l == 31) lo = 0;
    if (l >= NL) hi = 0;
  }
  // fold: digit l += Σ_j t[30 + j]·row_j[l]; t[30] is lane 30's lo,
  // t[30 + j] (j ≥ 1) lane j − 1's hi
  int32_t acc = l < NL ? lo : 0;
  acc += __shfl_sync(kFull, lo, NL) * s_fold[0][l];
#pragma unroll
  for (int j = 1; j <= NL; ++j) acc += __shfl_sync(kFull, hi, j - 1) * s_fold[j][l];
  return fp_squeeze(acc);
}

__device__ __forceinline__ int32_t fp_add(int32_t a, int32_t b) {
  return fp_squeeze(a + b);
}

// a − b (mod p), lazy: a + (2·MASK − b) + sub constant, digitwise
__device__ __forceinline__ int32_t fp_sub(int32_t a, int32_t b) {
  const int l = lane_id();
  return fp_squeeze(l < NL ? a + (2 * kMask - b) + s_subc[l] : 0);
}

// ---------------------------------------------------------------- types

struct Fp {
  int32_t d;
};

// Fp2 = Fp[u]/(u² + 1)
struct Fp2 {
  Fp re, im;
};

__device__ __forceinline__ Fp add(Fp a, Fp b) { return {fp_add(a.d, b.d)}; }
__device__ __forceinline__ Fp sub(Fp a, Fp b) { return {fp_sub(a.d, b.d)}; }
__device__ __forceinline__ Fp mul(Fp a, Fp b) { return {fp_mul(a.d, b.d)}; }
__device__ __forceinline__ Fp sqr(Fp a) { return {fp_mul(a.d, a.d)}; }

__device__ __forceinline__ Fp2 add(Fp2 a, Fp2 b) {
  return {add(a.re, b.re), add(a.im, b.im)};
}
__device__ __forceinline__ Fp2 sub(Fp2 a, Fp2 b) {
  return {sub(a.re, b.re), sub(a.im, b.im)};
}

// Karatsuba in the port's order: t0 = a0·b0, t1 = a1·b1,
// t2 = (a0 + a1)(b0 + b1); re = t0 − t1, im = t2 − (t0 + t1)
__device__ __forceinline__ Fp2 mul(Fp2 a, Fp2 b) {
  const Fp sa = add(a.re, a.im), sb = add(b.re, b.im);
  const Fp t0 = mul(a.re, b.re), t1 = mul(a.im, b.im), t2 = mul(sa, sb);
  return {sub(t0, t1), sub(t2, add(t0, t1))};
}

// re = (a0 + a1)(a0 − a1), im = 2·a0·a1
__device__ __forceinline__ Fp2 sqr(Fp2 a) {
  const Fp t0 = mul(add(a.re, a.im), sub(a.re, a.im));
  const Fp t1 = mul(a.re, a.im);
  return {t0, add(t1, t1)};
}

}  // namespace hb
