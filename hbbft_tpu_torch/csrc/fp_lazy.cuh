// The lazy BLS12-381 field (Fp) as warp-cooperative device functions, K
// field elements a warp.
//
// Replaces, inside the kernels that include it: hbbft_tpu/ops/pallas_fp.py
// :: mul_lazy_cols (the body of the Pallas kernel fp_mul_lazy_pallas) and
// the lazy add/sub of hbbft_tpu/ops/fp381.py, in the port's order
// (hbbft_tpu_torch/ops/fp381.py).  Every function computes the plain
// version's exact function of its operands, so every digit matches.
//
// Layout (Lanes<K>, K in {1, 2, 4}): a warp holds K field elements, G =
// 32/K lanes each; lane j of group g holds digits Kj .. Kj + K − 1 of
// element g ("chunk" j), so an element has 32 digit positions: digits 0..29
// and two spare positions, 30 and 31, that hold 0 between operations.  In
// shared memory an element is a row of 32 words and the K elements of a
// warp are K consecutive rows (a "slot row"); chunk c of row g sits at
// position c ^ g, so the K groups' chunks of one index lie in different
// banks.  Inside a lane, carries run in registers; a carry crosses lanes
// once a round of three passes.
//
// Carries: the plain rough carry is three parallel passes that drop the top
// digit's carry, so after three passes digit p is a function of the old
// digits p−3 .. p alone.  A lane gathers the three digits below its chunk in
// one round of independent shuffles and runs the three passes over its
// window locally (carry_window).  The squeeze (three passes over 31 digits,
// then four rounds of "fold the spare digit 30 back through row 0, three
// passes") does so five times; digit 30 is computed once a group, by the
// lane that holds it, and broadcast in the same exchange that brings the
// next round's window.
//
// The product a·b (K > 1): a 32-position cyclic convolution,
// output-stationary.  At step s (0 .. G−1) lane j multiplies chunk
// (j − s) mod G of a (one vector load) by the 2K − 1 digits of b around Ks
// (chunk s, a broadcast, and chunk s − 1 from the step before): K²
// multiply-adds into its K digit sums.  A term lands at position Kj + m
// (the low half of the 61-digit product) while s ≤ j and at 32 + Kj + m
// (the high half) after, so the lane snapshots its sums into the low half
// at s = j and the high half is the final sum less it; at s = 0 the terms
// below the chunk wrap to the high half, where only a·b[29] is not zero
// (K = 4).  An element so costs 1 024 multiply-adds, of which the product
// needs 900.  At K = 1, where that loop is one multiply-add a step behind
// two loads, lane l sums a[i]·b[l − i] and a[i]·b[l + 32 − i] from a
// zero-padded copy of b instead (two positions a lane, in four partial
// sums each).  Then the three passes over the 64 positions (61 .. 63 never
// read), the fold of digits 30 .. 60 against the residue rows (the high
// digits broadcast through a scratch row of the warp's own in shared
// memory), the squeeze.
//
// int32 never wraps: every digit of an operand lies in [0, 2^13], so every
// product is ≤ 2^26; a lane's convolution sum holds the terms of one low
// and one high position, at most 30, and the fold at most 31, so every sum
// stays < 2^31, as in the reference.  The windows compute the very
// intermediate values of the passes they replace.
//
// Every 32 lanes of a warp call each function together (the shuffles use
// the full mask); callers keep every branch warp-uniform.

#pragma once

#include <cstdint>

namespace hb {

constexpr int NL = 30;
constexpr int kBits = 13;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWords = 32;      // one element's row in shared memory
constexpr int kScratchRow = 40;    // fold scratch a group: t30, t31, 2 spare, t32 .. t63
constexpr int kFoldRows = NL + 1;  // residue rows 2^(13 (NL + j)) mod p, j = 0 .. 30

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Words of a group's scratch: the fold's row, and at K = 1 the product's
// zero-padded copy of b (64 pairs), whose padding zero_scratch clears once
// per kernel
template <int K>
__host__ __device__ constexpr int scratch_words() {
  return kScratchRow + (K == 1 ? 128 : 0);
}

template <int K>
__device__ __forceinline__ void zero_scratch(int32_t* scratch) {
  if constexpr (K == 1) {
    for (int i = lane_id(); i < scratch_words<1>(); i += 32) scratch[i] = 0;
    __syncwarp();
  }
}

template <int K>
struct Lanes {
  static_assert(K == 1 || K == 2 || K == 4, "K elements a warp: 1, 2 or 4");
  static constexpr int G = 32 / K;  // lanes an element
  __device__ static int group() { return lane_id() / G; }
  __device__ static int chunk() { return lane_id() & (G - 1); }
  // word offset, in its row, of chunk c of a row of group g
  __device__ static int at(int c, int g) { return K * (c ^ g); }
};

template <int K>
struct Vec;
template <>
struct Vec<1> { using T = int32_t; };
template <>
struct Vec<2> { using T = int2; };
template <>
struct Vec<4> { using T = int4; };

template <int K>
__device__ __forceinline__ void ld(const int32_t* p, int32_t (&v)[K]) {
  const typename Vec<K>::T x = *reinterpret_cast<const typename Vec<K>::T*>(p);
  if constexpr (K == 1) {
    v[0] = x;
  } else if constexpr (K == 2) {
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
}

template <int K>
__device__ __forceinline__ void st(int32_t* p, const int32_t (&v)[K]) {
  typename Vec<K>::T x;
  if constexpr (K == 1) {
    x = v[0];
  } else if constexpr (K == 2) {
    x = make_int2(v[0], v[1]);
  } else {
    x = make_int4(v[0], v[1], v[2], v[3]);
  }
  *reinterpret_cast<typename Vec<K>::T*>(p) = x;
}

// This lane's constants: its digits' column of residue row 0 (the squeeze's
// fold), of 2·MASK + the sub constant, the masks of digits < 30 and of
// "digit Kj − d exists", and the residue rows themselves — in registers for
// K = 1, in shared memory (kFoldRows rows of 32 words, digits 30 and 31
// zero) for K > 1.
template <int K>
struct FieldLane {
  int32_t row0[K];
  int32_t row0w[4];  // row0[d]: residue row 0 at position Kj − d, 0 where it does not exist
  int32_t subk[K];   // 2·MASK + sub constant at digits < 30, else 0
  int32_t keep[K];   // all ones at digits < 30, else 0
  int32_t below[4];
  int32_t fold[K == 1 ? kFoldRows : 1];
  const int32_t* fold_s;
};

// The residue rows into shared memory (K > 1), by every thread of the
// block; the caller then barriers before load_field.
__device__ __forceinline__ void stage_fold(int32_t* fold_s, const int32_t* __restrict__ fold) {
  for (int i = threadIdx.x; i < kFoldRows * kRowWords; i += blockDim.x) {
    const int j = i / kRowWords, p = i % kRowWords;
    fold_s[i] = p < NL ? fold[j * NL + p] : 0;
  }
}

// subc == nullptr: zeros (a kernel that never subtracts)
template <int K>
__device__ __forceinline__ void load_field(FieldLane<K>& f, const int32_t* __restrict__ fold,
                                           const int32_t* __restrict__ subc,
                                           const int32_t* fold_s) {
  const int p0 = K * Lanes<K>::chunk();
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int p = p0 + m;
    f.row0[m] = p < NL ? fold[p] : 0;
    f.subk[m] = p < NL ? 2 * kMask + (subc != nullptr ? subc[p] : 0) : 0;
    f.keep[m] = p < NL ? -1 : 0;
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    f.below[d] = p0 >= d ? -1 : 0;
    f.row0w[d] = (d > 0 && p0 >= d && p0 - d < NL) ? fold[p0 - d] : 0;
  }
  if constexpr (K == 1) {
#pragma unroll
    for (int j = 0; j < kFoldRows; ++j) f.fold[j] = p0 < NL ? fold[j * NL + p0] : 0;
  }
  f.fold_s = fold_s;
}

// Three rough passes over this lane's digits v[0 .. K) given the three
// digits below them, w[d] at position Kj − d (0 where it does not exist):
// pass 1 over positions Kj−2 .. Kj+K−1, pass 2 from Kj−1, pass 3 from Kj.
// Digits are never negative, so >> is the plain version's shift.
template <int K>
__device__ __forceinline__ void carry_window(const int32_t (&w)[4], int32_t (&v)[K]) {
  int32_t x[K + 3] = {w[3], w[2], w[1]};
#pragma unroll
  for (int m = 0; m < K; ++m) x[3 + m] = v[m];
#pragma unroll
  for (int pass = 1; pass <= 3; ++pass) {
#pragma unroll
    for (int q = K + 2; q >= pass; --q) x[q] = (x[q] & kMask) + (x[q - 1] >> kBits);
  }
#pragma unroll
  for (int m = 0; m < K; ++m) v[m] = x[3 + m];
}

// The three digits below this lane's chunk, from the lanes below in the
// group (0 below digit 0).
template <int K>
__device__ __forceinline__ void window_below(const int32_t (&v)[K], const FieldLane<K>& f,
                                             int32_t (&w)[4]) {
  constexpr int G = Lanes<K>::G;
#pragma unroll
  for (int d = 1; d <= 3; ++d) {
    const int off = (d + K - 1) / K;  // the lane that holds digit Kj − d, below
    w[d] = __shfl_up_sync(kFull, v[K * off - d], off, G) & f.below[d];
  }
}

// Digits < 2^31 at positions 0..29, 0 at 30 and 31 → lazy digits at 0..29,
// 0 at 30 and 31: three passes over the 31 digits (digit 30 the spare), then
// four times: fold the spare digit back through row 0, three passes.  The
// spare digit left by the last passes is dropped, as the plain version
// returns only the low NL digits.  Position 31 takes the spare digit's
// carries, which nothing reads, and is cleared with it.  A round's one
// exchange brings the spare digit and the window of the next passes (the
// digits below, after this round's passes) together, and the lane folds
// both, so a round waits on one shuffle.
template <int K>
__device__ __forceinline__ void squeeze(int32_t (&v)[K], const FieldLane<K>& f) {
  constexpr int G = Lanes<K>::G;
  int32_t w[4];
  window_below<K>(v, f, w);
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    carry_window<K>(w, v);
    if (round == 4) break;
    const int32_t top = __shfl_sync(kFull, v[NL % K], NL / K, G);
    window_below<K>(v, f, w);
#pragma unroll
    for (int m = 0; m < K; ++m) v[m] = (v[m] & f.keep[m]) + top * f.row0[m];
#pragma unroll
    for (int d = 1; d <= 3; ++d) w[d] += top * f.row0w[d];
  }
#pragma unroll
  for (int m = 0; m < K; ++m) v[m] &= f.keep[m];
}

// a·b before its squeeze (see the header comment): a, b are this group's
// rows in shared memory (32 words, 16-byte aligned, chunks at Lanes::at,
// digits 30 and 31 zero); scratch: this group's scratch_words<K>() words
// of the warp's own (16-byte aligned; zero_scratch once per kernel).
// Result: this lane's digits, 0 at 30 and 31.
template <int K>
__device__ __forceinline__ void fp_mul_unsqueezed(const int32_t* a, const int32_t* b,
                                                  int32_t* scratch, const FieldLane<K>& f,
                                                  int32_t (&out)[K]) {
  using L = Lanes<K>;
  constexpr int G = L::G;
  const int g = L::group(), j = L::chunk();
  int32_t lo[K], hi[K];
  if constexpr (K == 1) {
    // one element a warp: b padded with zeros, bz[32 + i] = b[i], 0 below 32
    // and from 64, stored as pairs pz[k] = (bz[k], bz[k + 32]), so that at
    // step i lane l reads b[l − i] for t[l] and b[l + 32 − i] for t[l + 32]
    // in one 8-byte load, with no branch on i ≤ l; four partial sums a digit
    int2* pz = reinterpret_cast<int2*>(scratch + kScratchRow);
    __syncwarp();  // the previous product's reads of scratch are done
    const int32_t bl = b[j];
    pz[j].y = bl;
    pz[32 + j].x = bl;
    __syncwarp();
    int32_t lo4[4] = {0, 0, 0, 0}, hi4[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 a4 = reinterpret_cast<const int4*>(a)[q];  // broadcast
      const int32_t av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * q + k;
        if (i < NL) {
          const int2 bb = pz[32 + j - i];
          lo4[k] += av[k] * bb.x;
          hi4[k] += av[k] * bb.y;
        }
      }
    }
    lo[0] = (lo4[0] + lo4[1]) + (lo4[2] + lo4[3]);
    hi[0] = (hi4[0] + hi4[1]) + (hi4[2] + hi4[3]);
  } else {
    int32_t acc[K], wrap[K];
#pragma unroll
    for (int m = 0; m < K; ++m) acc[m] = lo[m] = wrap[m] = 0;
    int32_t bprev[K];
    ld<K>(b + L::at(G - 1, g), bprev);  // chunk −1 ≡ G − 1 at s = 0
#pragma unroll
    for (int s = 0; s < G; ++s) {
      int32_t ach[K], bcur[K];
      ld<K>(a + L::at((j - s) & (G - 1), g), ach);
      ld<K>(b + L::at(s, g), bcur);  // a broadcast within the group
#pragma unroll
      for (int m = 0; m < K; ++m) {
        int32_t step = 0;  // the step's terms apart, so the sum's chain is one add a step
#pragma unroll
        for (int r = 0; r < K; ++r) {
          // b digit Ks + m − r (both indices kept in range for the compiler)
          const int32_t bv = m >= r ? bcur[(m - r) & (K - 1)] : bprev[(K + m - r) & (K - 1)];
          if (s > 0 || m >= r) {
            step += ach[r] * bv;
          } else if (32 + m - r < NL) {  // the wrapped term, high half
            wrap[m] += ach[r] * bv;
          }
        }
        acc[m] += step;
      }
      const bool last_low = j == s;
#pragma unroll
      for (int m = 0; m < K; ++m) lo[m] = last_low ? acc[m] : lo[m];
#pragma unroll
      for (int m = 0; m < K; ++m) bprev[m] = bcur[m];
    }
#pragma unroll
    for (int m = 0; m < K; ++m) hi[m] = acc[m] - lo[m] + wrap[m];
  }

  // three passes over the 64 positions: the low half's window is the three
  // low digits below; the high half's the high digits below, or for its
  // first digits the low half's top (one rotating shuffle of each half)
  {
    int32_t wl[4], wh[4];
#pragma unroll
    for (int d = 1; d <= 3; ++d) {
      const int off = (d + K - 1) / K, dj = K * off - d;
      const int src = (j - off) & (G - 1);
      const int32_t rl = __shfl_sync(kFull, lo[dj], src, G);
      const int32_t rh = __shfl_sync(kFull, hi[dj], src, G);
      wl[d] = rl & f.below[d];
      wh[d] = f.below[d] ? rh : rl;
    }
    carry_window<K>(wl, lo);
    carry_window<K>(wh, hi);
  }

  // fold: digit p += Σ_j t[30 + j]·row_j[p], t[30 .. 60] broadcast from the
  // scratch row (t30, t31 at words 0, 1; t[32 + i] at word 4 + i)
  __syncwarp();  // the previous product's reads of scratch are done
  st<K>(scratch + 4 + K * j, hi);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if (K * j + m >= NL) scratch[K * j + m - NL] = lo[m];
  }
  __syncwarp();
  constexpr int P = K == 1 ? 4 : 2;  // partial sums a digit, for the multiply-adds' latency
  int32_t sum[P][K];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int m = 0; m < K; ++m) sum[q][m] = q == 0 ? (lo[m] & f.keep[m]) : 0;
  }
  const int2 t3031 = *reinterpret_cast<const int2*>(scratch);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int4 h4 = *reinterpret_cast<const int4*>(scratch + 4 + 4 * q);
    const int32_t tv[6] = {t3031.x, t3031.y, h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int u = q == 0 ? 0 : 2; u < 6; ++u) {
      const int jj = q == 0 ? u : 4 * q + u;  // t[30 + jj]
      if (jj < kFoldRows) {
        int32_t row[K];
        if constexpr (K == 1) {
          row[0] = f.fold[jj];
        } else {
          ld<K>(f.fold_s + jj * kRowWords + K * j, row);
        }
#pragma unroll
        for (int m = 0; m < K; ++m) sum[jj % P][m] += tv[u] * row[m];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < K; ++m) {
    int32_t x = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) x += sum[q][m];
    out[m] = x;
  }
}

// The field as ladder_steps.cuh's field policy, K elements a warp: a row
// of kRowWords words an element, kDigits digits a lane at word own() of
// its group's row, kScratchWords words of scratch a warp, kConstWords
// words of the block's constants in shared memory (the residue rows, K > 1).
template <int K>
struct LazyField {
  static constexpr int kK = K;
  static constexpr int kNL = NL;
  static constexpr int kRowWords = hb::kRowWords;
  static constexpr int kDigits = K;
  static constexpr int kScratchWords = K * scratch_words<K>();
  static constexpr int kConstWords = K > 1 ? kFoldRows * hb::kRowWords : 0;
  using Lane = FieldLane<K>;
  struct Consts {
    const int32_t* fold;
    const int32_t* subc;
  };

  __device__ static int group() { return Lanes<K>::group(); }
  __device__ static int own() { return Lanes<K>::at(Lanes<K>::chunk(), Lanes<K>::group()); }
  __device__ static int first_digit() { return K * Lanes<K>::chunk(); }
  // by every thread of the block, before its barrier
  __device__ static void stage(int32_t* const_s, int32_t* wscratch, const Consts& c) {
    zero_scratch<K>(wscratch + group() * scratch_words<K>());
    if constexpr (K > 1) stage_fold(const_s, c.fold);
  }
  __device__ static void load(Lane& f, const Consts& c, const int32_t* const_s) {
    load_field<K>(f, c.fold, c.subc, const_s);
  }
  __device__ static void mul(const int32_t* a, const int32_t* b, int32_t* wscratch, const Lane& f,
                             int32_t (&out)[K]) {
    fp_mul_unsqueezed<K>(a, b, wscratch + group() * scratch_words<K>(), f, out);
  }
  __device__ static void squeeze(int32_t (&v)[K], const Lane& f) { hb::squeeze<K>(v, f); }
};

}  // namespace hb
