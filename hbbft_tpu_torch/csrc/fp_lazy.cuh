// The lazy BLS12-381 field (Fp) as warp-cooperative device functions.
//
// Replaces, inside the kernels that include it: hbbft_tpu/ops/pallas_fp.py
// :: mul_lazy_cols (the body of the Pallas kernel fp_mul_lazy_pallas) and
// the lazy add/sub of hbbft_tpu/ops/fp381.py, in the port's order
// (hbbft_tpu_torch/ops/fp381.py).  Every function computes the plain
// version's exact function of its operands, so every digit matches.
//
// Layout: one warp holds one field element, one 13-bit digit a lane.  Lane
// l < 30 holds digit l; lanes 30 and 31 hold 0 between operations (inside
// one they may hold anything that no lane < 30 reads).  The operands of a
// product are rows of 32 digits in shared memory (16-byte aligned), so a
// lane reads any digit directly.  A product's 61 digits sit two a lane:
// lane l holds t[l] ("lo") and t[32 + l] ("hi").
//
// Carries: the plain rough carry is three parallel passes that drop the top
// digit's carry, so after three passes digit p is a function of the old
// digits p-3 .. p alone (carry3).  A lane gathers that window in one round
// of independent shuffles and runs the three passes locally: one shuffle
// latency instead of three.  The squeeze (three passes, then four rounds of
// "fold the spare digit 30 back through row 0, three passes") does the
// same; every lane also gathers digits 27..29 and computes digit 30 itself,
// so a round is one round of six shuffles and the squeeze five rounds, not
// nineteen dependent shuffles.
//
// int32 never wraps: every digit of an operand lies in [0, 2^13], so every
// product is < 2^26 and every digit sum (30 products in the convolution,
// 31 in the fold) stays < 2^31, as in the reference.  The window computes
// the very intermediate values of the passes it replaces.
//
// Each lane keeps its column of the residue rows 2^(13 j) mod p
// (j = 30..60), of the sub constant and its window masks in registers
// (FieldLane).  An SM sub-partition issues int32 instructions at half a
// warp a clock, so the functions spend instructions sparingly: the window
// masks are ANDs, the product reads b from a zero-padded copy without a
// branch on i ≤ l, and its sums run as four partial sums.  Every 32 lanes
// of a warp call each function together (the shuffles use the full mask);
// callers keep every branch warp-uniform.

#pragma once

#include <cstdint>

namespace hb {

constexpr int NL = 30;
constexpr int kBits = 13;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Lane l's column of the (NL + 1, NL) residue rows (fold[j]: digit l of
// 2^(13 (NL + j)) mod p) and of the sub constant (-2 (2^390 - 1) mod p);
// 0 on lanes 30 and 31.
struct FieldLane {
  int32_t fold[NL + 1];
  int32_t subc;
  int32_t below[4];  // below[k]: all ones where lane l ≥ k (digit l − k exists), else 0
};

// subc == nullptr: zeros (a kernel that never subtracts)
__device__ __forceinline__ void load_field(FieldLane& f, const int32_t* __restrict__ fold,
                                           const int32_t* __restrict__ subc) {
  const int l = lane_id();
#pragma unroll
  for (int j = 0; j <= NL; ++j) f.fold[j] = l < NL ? fold[j * NL + l] : 0;
  f.subc = (subc != nullptr && l < NL) ? subc[l] : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) f.below[k] = l >= k ? -1 : 0;
}

// Digit p after three rough passes, from the old digits x0..x3 at
// positions p-3 .. p (0 below position 0).  Digits are never negative, so
// >> is the plain version's shift.
__device__ __forceinline__ int32_t carry3(int32_t x0, int32_t x1, int32_t x2, int32_t x3) {
  const int32_t a1 = (x1 & kMask) + (x0 >> kBits);  // p-2, pass 1
  const int32_t b1 = (x2 & kMask) + (x1 >> kBits);  // p-1, pass 1
  const int32_t c1 = (x3 & kMask) + (x2 >> kBits);  // p,   pass 1
  const int32_t b2 = (b1 & kMask) + (a1 >> kBits);  // p-1, pass 2
  const int32_t c2 = (c1 & kMask) + (b1 >> kBits);  // p,   pass 2
  return (c2 & kMask) + (b2 >> kBits);              // p,   pass 3
}

// Digits < 2^31 on lanes 0..29 → lazy digits on lanes 0..29, 0 on lanes 30
// and 31: three passes over the 31 digits (digit 30 the spare), then four
// times: fold the spare digit back through row 0, three passes.  The spare
// digit left by the last passes is dropped, as the plain version returns
// only the low NL digits.  Digit 30 enters every round as 0, so its window
// is (27, 28, 29, 0); what lanes 30 and 31 hold on the way is never read by
// lanes 0..29 (windows look down, the spare digit is computed from 27..29).
__device__ __forceinline__ int32_t squeeze(int32_t v, const FieldLane& f) {
  const int l = lane_id();
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    const int32_t w1 = __shfl_up_sync(kFull, v, 1);
    const int32_t w2 = __shfl_up_sync(kFull, v, 2);
    const int32_t w3 = __shfl_up_sync(kFull, v, 3);
    const int32_t t27 = __shfl_sync(kFull, v, 27);
    const int32_t t28 = __shfl_sync(kFull, v, 28);
    const int32_t t29 = __shfl_sync(kFull, v, 29);
    const int32_t y = carry3(w3 & f.below[3], w2 & f.below[2], w1 & f.below[1], v);
    if (round == 4) return l < NL ? y : 0;
    const int32_t top = carry3(t27, t28, t29, 0);
    v = y + top * f.fold[0];
  }
  return 0;  // not reached
}

// a·b before its squeeze: the 30×30 convolution, three rough passes over
// the 61 digits (the carry out of digit 60 dropped), the fold of digits
// 30..60 against the residue rows.  a, b: shared rows of 32 digits
// (16-byte aligned, digits 30 and 31 zero); scratch: 192 ints of this
// warp's own in shared memory (16-byte aligned), of which 64..191 hold the
// zero-padded copy of b (zero_scratch once per kernel).
__device__ __forceinline__ int32_t fp_mul_unsqueezed(const int32_t* a, const int32_t* b,
                                                     int32_t* scratch, const FieldLane& f) {
  const int l = lane_id();
  // b padded with zeros: bz[32 + j] = b[j], 0 elsewhere (j < 0 or j ≥ 32),
  // stored as pairs pz[k] = (bz[k], bz[k + 32]), so that at step i lane l
  // reads b[l − i] for t[l] and b[l + 32 − i] for t[l + 32] in one 8-byte
  // load, with no branch on i ≤ l
  int2* pz = reinterpret_cast<int2*>(scratch + 64);
  __syncwarp();  // the previous product's reads of scratch are done
  const int32_t bl = b[l];
  pz[l].y = bl;
  pz[32 + l].x = bl;
  __syncwarp();
  // four partial sums a digit, so the multiply-adds do not wait on each other
  int32_t lo4[4] = {0, 0, 0, 0}, hi4[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 a4 = reinterpret_cast<const int4*>(a)[q];  // broadcast
    const int32_t av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * q + k;
      if (i < NL) {
        const int2 bb = pz[32 + l - i];
        lo4[k] += av[k] * bb.x;
        hi4[k] += av[k] * bb.y;
      }
    }
  }
  int32_t lo = (lo4[0] + lo4[1]) + (lo4[2] + lo4[3]);
  int32_t hi = (hi4[0] + hi4[1]) + (hi4[2] + hi4[3]);
  // three passes, windowed: position l's window is lo[l-3 .. l-1] (0 below
  // 0); position 32 + l's is hi[l-k], or lo[32 + l - k] where l < k — one
  // rotating shuffle of each half gives both.  hi on lanes 29..31
  // (positions 61..63, which do not exist) is never read.
  int32_t wl[3], wh[3];
#pragma unroll
  for (int k = 1; k <= 3; ++k) {
    const int32_t rl = __shfl_sync(kFull, lo, (l - k) & 31);
    const int32_t rh = __shfl_sync(kFull, hi, (l - k) & 31);
    wl[k - 1] = rl & f.below[k];
    wh[k - 1] = f.below[k] ? rh : rl;
  }
  lo = carry3(wl[2], wl[1], wl[0], lo);
  hi = carry3(wh[2], wh[1], wh[0], hi);
  // fold: digit l += Σ_j t[30 + j]·row_j[l], t[30..60] read back as
  // broadcasts from the warp's scratch, in four partial sums
  scratch[l] = lo;
  scratch[32 + l] = hi;
  __syncwarp();
  const int2 t30 = *reinterpret_cast<const int2*>(scratch + 30);
  int32_t acc[4] = {lo, t30.x * f.fold[0], t30.y * f.fold[1], 0};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 h4 = reinterpret_cast<const int4*>(scratch + 32)[q];
    const int32_t hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;  // t[32 + j]
      if (j <= 28) acc[k] += hv[k] * f.fold[2 + j];
    }
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Zero this warp's scratch (the padding of fp_mul_unsqueezed's copy of b)
__device__ __forceinline__ void zero_scratch(int32_t* scratch) {
  for (int i = lane_id(); i < 192; i += 32) scratch[i] = 0;
  __syncwarp();
}

// a − b (mod p) before its squeeze, lazy: a + (2·MASK − b) + sub constant,
// digitwise (a + b needs no helper; lanes 30 and 31 are not read by the
// squeeze)
__device__ __forceinline__ int32_t fp_sub_unsqueezed(int32_t a, int32_t b, const FieldLane& f) {
  return a + (2 * kMask - b) + f.subc;
}

}  // namespace hb
