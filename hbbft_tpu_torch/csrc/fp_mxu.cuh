// The 8-bit-digit BLS12-381 field (Fp) as warp-cooperative device
// functions, K field elements a warp, its products on the tensor cores: the
// field policy of ladder_steps.cuh that ladder_mxu.cu runs.
//
// Replaces, inside that kernel: hbbft_tpu/ops/fp381_mxu.py :: fp_mul (:178;
// the digit convolution :159 _conv_mxu, a (B, 2401) @ (2401, 97) one-hot
// matmul, and the fold, (B, 51) @ (51, 49), on the TPU's matrix unit; the
// carries and the squeeze :136 on its vector unit), fp_add and fp_sub.
// Every function computes the plain version's exact function of its
// operands (ops/fp381_mxu.py), so every digit matches.
//
// Layout (Field<K>, K in {1, 2, 4}): a warp holds K field elements, G =
// 32/K lanes each; lane j of group g holds the D = 2K digits D·j … D·j + D
// − 1 of element g.  An element is a row of 64 words in shared memory:
// digits 0 … 48, then zeros between operations.  Carries run in registers
// over a window: after three rough passes digit p is a function of the old
// digits p − 3 … p alone, so a lane gathers the three digits below its own
// (one round of shuffles) and runs the passes locally.
//
// The squeeze (ops/fp381_mxu.py :: _squeeze: three carry positions 49 …
// 51, a rough carry, then three rounds that fold them back through the
// squeeze rows and carry again): four rounds of passes; between two, one
// exchange brings positions 49, 50, 51 (one lane's or two) and the next
// window, and the lane folds both, so a round waits on one exchange.
//
// The product of the K elements (the whole warp, one element of each
// group; a group's operand rows may lie anywhere, so each is found by a
// shuffle of its address), stage by stage through the warp's scratch:
//   1. Each element's convolution t_k = Σ a_i·b_j (i + j = k), 97
//      positions, as 4 m16n8k16 f16 products of a Toeplitz block:
//      D[m][q] = Σ_c a_{m−c}·b_{16q+c} (m < 64, c < 16, q < 4), so that t_k
//      = Σ_q D[k − 16q][q].  A[m][c] = a_{m−c} is read from the operand's
//      row as f16 pairs (a_y, a_{y−1}); B's column q is digits 16q … 16q +
//      15 of b.  Quad lanes 0 and 1 hold columns 0, 1 and 2, 3: each adds
//      its two, and one shuffle gives each the other's sums of the
//      positions it keeps (lane 0 the even eighths, lane 1 the odd).  Every
//      sum is ≤ 49·383² < 2^23: exact in f32.
//   2. The rough carry over the 100 positions (the top carry dropped), a
//      group's lanes over its element's positions, 4K a lane; positions
//      from 100 written as 0.
//   3. The fold of the 51 positions from 49 through 2^(8(49 + m)) mod p:
//      the (64 × 64 padded) fold matrix as A against the K elements' high
//      digits as B's columns 0 … K − 1, so the K products share 16 mma and
//      one read of the fold's fragments; sums ≤ 51·256·255 < 2^22.
//   4. Each lane's D digits: the carried low digits plus the fold's.
// The f16 operands are digits < 1024 (the lazy digits stay ≤ 383), so a
// pair converts exactly as 1024 + n with the bias subtracted (pack_h2).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hb_mxu {

constexpr int NL = 49;
constexpr int kBits = 8;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWords = 64;                // one element's row: digits 0 … 48, zeros after
constexpr int kProdWords = 128;              // a product's positions: 0 … 99, zeros after
constexpr int kFoldWords = 64;               // the fold's output digits
constexpr int kFragWords = 16 * 32 * 4;      // the fold matrix as A fragments, [m-tile][k-step][lane][4]
constexpr int kSqStride = 68;                // squeeze row r at words 4 + p of its 68 (0 outside 0 … 48)
constexpr int kSqWords = 3 * kSqStride;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Two integers in [0, 1024) as an f16 pair (lo in the low half): 1024 + n
// has n as its mantissa, and the bias comes off exactly
__device__ __forceinline__ uint32_t pack_h2(int lo, int hi) {
  const uint32_t biased = 0x64006400u + static_cast<uint32_t>(lo) + (static_cast<uint32_t>(hi) << 16);
  uint32_t out;
  asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(out) : "r"(biased), "r"(0x64006400u));
  return out;
}

// d += A·B, m16n8k16, f16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// N consecutive words, 16-byte aligned (N a multiple of 4) or 8-byte (N = 2)
template <int N>
__device__ __forceinline__ void ld(const int32_t* p, int32_t (&v)[N]) {
  if constexpr (N == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(p)[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  }
}

// Three rough passes over x[0 .. n): x[0 .. 3) the window below, whose
// digits are not computed (pass 1 from x[1], pass 2 from x[2], pass 3 from
// x[3]); digits are never negative, so >> is the plain version's shift
template <int N>
__device__ __forceinline__ void passes(int32_t (&x)[N]) {
#pragma unroll
  for (int pass = 1; pass <= 3; ++pass) {
#pragma unroll
    for (int q = N - 1; q >= pass; --q) x[q] = (x[q] & kMask) + (x[q - 1] >> kBits);
  }
}

template <int K>
struct Field {
  static_assert(K == 1 || K == 2 || K == 4, "K elements a warp: 1, 2 or 4");
  static constexpr int kK = K;
  static constexpr int kNL = NL;
  static constexpr int kRowWords = hb_mxu::kRowWords;
  static constexpr int G = 32 / K;           // lanes an element
  static constexpr int kDigits = 2 * K;      // digits a lane
  static constexpr int kSpan = 4 * K;        // product positions a lane in the product's carry
  static constexpr int kScratchWords = K * (kProdWords + kFoldWords);  // a warp's
  static constexpr int kConstWords = kFragWords + kSqWords;           // the block's

  struct Consts {
    const int32_t* frag;  // kFragWords words: ops/ladder_mxu.py :: fold_fragments
    const int32_t* sq;    // (3, NL): the squeeze rows
    const int32_t* subc;  // (NL,): the sub constant
  };
  struct Lane {
    int32_t subk[kDigits];  // 2·MASK + the sub constant at digits < NL, else 0
    const uint4* frag;      // the fold's fragments, in shared memory
    const int32_t* sq;      // the squeeze rows, in shared memory (kSqStride a row)
  };

  __device__ static int group() { return lane_id() / G; }
  __device__ static int chunk() { return lane_id() & (G - 1); }
  __device__ static int own() { return kDigits * chunk(); }
  __device__ static int first_digit() { return own(); }

  // the fold's fragments and the squeeze rows into shared memory, by every
  // thread of the block, before its barrier
  __device__ static void stage(int32_t* const_s, int32_t*, const Consts& c) {
    for (int i = threadIdx.x; i < kFragWords; i += blockDim.x) const_s[i] = c.frag[i];
    for (int i = threadIdx.x; i < kSqWords; i += blockDim.x) {
      const int r = i / kSqStride, p = i % kSqStride - 4;
      const_s[kFragWords + i] = (p >= 0 && p < NL) ? c.sq[r * NL + p] : 0;
    }
  }
  __device__ static void load(Lane& f, const Consts& c, const int32_t* const_s) {
    const int p0 = own();
#pragma unroll
    for (int m = 0; m < kDigits; ++m) f.subk[m] = p0 + m < NL ? 2 * kMask + c.subc[p0 + m] : 0;
    f.frag = reinterpret_cast<const uint4*>(const_s);
    f.sq = const_s + kFragWords;
  }

  // Group p's operand row, given this lane's: an offset from the block's
  // constants (all in one shared-memory window), shuffled from group p
  __device__ static const int32_t* row_of(const int32_t* mine, const Lane& f, int p) {
    if constexpr (K == 1) {
      return mine;
    } else {
      const int32_t* origin = f.sq;
      const int off = __shfl_sync(kFull, static_cast<int>(mine - origin), p * G);
      return origin + off;
    }
  }

  // The digits at positions D·j − 1, − 2, − 3 of this lane's group, w[1 .. 3]
  // (0 below position 0)
  __device__ static void window_below(const int32_t (&v)[kDigits], int32_t (&w)[4]) {
    const int j = chunk();
#pragma unroll
    for (int d = 1; d <= 3; ++d) {
      constexpr int D = kDigits;
      const int off = (d + D - 1) / D;  // the lane that holds position D·j − d, below
      const int32_t x = __shfl_up_sync(kFull, v[D * off - d], off, G);
      w[d] = j >= off ? x : 0;
    }
  }

  __device__ static void carry_window(const int32_t (&w)[4], int32_t (&v)[kDigits]) {
    int32_t x[kDigits + 3] = {w[3], w[2], w[1]};
#pragma unroll
    for (int m = 0; m < kDigits; ++m) x[3 + m] = v[m];
    passes(x);
#pragma unroll
    for (int m = 0; m < kDigits; ++m) v[m] = x[3 + m];
  }

  // Digits < 2^31 at positions < NL, 0 from NL → lazy digits at < NL, 0
  // from NL (ops/fp381_mxu.py :: _squeeze).  Positions 52 … 63 take the
  // carries the plain version drops, which nothing reads.
  __device__ static void squeeze(int32_t (&v)[kDigits], const Lane& f) {
    constexpr int D = kDigits;
    const int p0 = own();
    int32_t sq[3][D], sw[3][4];  // the squeeze rows at this lane's positions and its window's
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int32_t* row = f.sq + r * kSqStride + 4 + p0;
#pragma unroll
      for (int m = 0; m < D; ++m) sq[r][m] = row[m];
#pragma unroll
      for (int d = 1; d <= 3; ++d) sw[r][d] = row[-d];
    }
    int32_t w[4];
    window_below(v, w);
#pragma unroll
    for (int round = 0; round < 4; ++round) {
      carry_window(w, v);
      if (round == 3) break;
      const int32_t t0 = __shfl_sync(kFull, v[49 % D], 49 / D, G);
      const int32_t t1 = __shfl_sync(kFull, v[50 % D], 50 / D, G);
      const int32_t t2 = __shfl_sync(kFull, v[51 % D], 51 / D, G);
      window_below(v, w);
#pragma unroll
      for (int m = 0; m < D; ++m) {
        v[m] = (p0 + m < NL ? v[m] : 0) + t0 * sq[0][m] + t1 * sq[1][m] + t2 * sq[2][m];
      }
#pragma unroll
      for (int d = 1; d <= 3; ++d) {
        w[d] = (p0 - d < NL ? w[d] : 0) + t0 * sw[0][d] + t1 * sw[1][d] + t2 * sw[2][d];
      }
    }
#pragma unroll
    for (int m = 0; m < D; ++m) v[m] = p0 + m < NL ? v[m] : 0;
  }

  // a·b before its squeeze (see the head comment) for the K elements of the
  // warp: a, b this lane's group's rows (64 words, 16-byte aligned, zeros
  // from NL), ws the warp's kScratchWords words.  Result: this lane's
  // digits, 0 from NL.
  __device__ static void mul(const int32_t* a, const int32_t* b, int32_t* ws, const Lane& f,
                             int32_t (&out)[kDigits]) {
    const int lane = lane_id(), qg = lane >> 2, qt = lane & 3;
    int32_t* T = ws;                       // [K][kProdWords]
    int32_t* F = ws + K * kProdWords;      // [K][kFoldWords]
    __syncwarp();  // the previous product's reads of the scratch are done

    // 1. the convolutions: pair i (0 … 8) is (a_y, a_{y−1}) at y = qg −
    // 2qt + 8(i − 1); tile mt's A is pairs 2mt + 1, 2mt + 2, 2mt, 2mt + 1
    // (rows qg, qg + 8 and columns 2qt (+1), 2qt + 8 (+9) of the block)
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const int32_t* ap = row_of(a, f, p);
      const int32_t* bp = row_of(b, f, p);
      const int y0 = qg - 2 * qt;  // −6 … 7
      uint32_t pr[9];
      pr[0] = 0;  // y ≤ −1
      const int lo = ap[y0 > 0 ? y0 : 0], hi = ap[y0 > 1 ? y0 - 1 : 0];  // in the row
      pr[1] = pack_h2(y0 >= 0 ? lo : 0, y0 >= 1 ? hi : 0);
#pragma unroll
      for (int i = 2; i < 9; ++i) {
        const int y = y0 + 8 * (i - 1);  // 10 … 63
        pr[i] = pack_h2(ap[y], ap[y - 1]);
      }
      uint32_t b0 = 0, b1 = 0;
      if (qg < 4) {  // B column q = qg: digits 16q … 16q + 15 of b
        const int j = 16 * qg + 2 * qt;
        const int2 u = *reinterpret_cast<const int2*>(bp + j);
        const int2 v = *reinterpret_cast<const int2*>(bp + j + 8);
        b0 = pack_h2(u.x, u.y);
        b1 = pack_h2(v.x, v.y);
      }
      float d[4][4] = {};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma(d[mt], pr[2 * mt + 1], pr[2 * mt + 2], pr[2 * mt], pr[2 * mt + 1], b0, b1);
      }
      // position 8i + qg (i = 2u + h) is Σ_q D[16(u − q) + 8h + qg][q]:
      // quad lane 0 holds columns 0, 1 (tiles u, u − 1), lane 1 columns 2, 3
      // (tiles u − 2, u − 3); lanes 2 and 3 the zero columns 4 … 7
      float s[14];
#pragma unroll
      for (int u = 0; u < 7; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s0 = 0.f, s1 = 0.f;
          if (u < 4) s0 += d[u][2 * h];
          if (u >= 1 && u <= 4) s0 += d[u - 1][2 * h + 1];
          if (u >= 2 && u <= 5) s1 += d[u - 2][2 * h];
          if (u >= 3) s1 += d[u - 3][2 * h + 1];
          s[2 * u + h] = qt == 0 ? s0 : s1;
        }
      }
      // lane 0 keeps the even i, lane 1 the odd: each sends the other's
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        const float mine = qt == 1 ? s[2 * r + 1] : s[2 * r];
        const float got = __shfl_xor_sync(kFull, qt == 1 ? s[2 * r] : s[2 * r + 1], 1);
        if (qt < 2) T[p * kProdWords + 8 * (2 * r + qt) + qg] = __float2int_rn(mine + got);
      }
    }
    __syncwarp();

    // 2. the rough carry over positions 0 … 99, kSpan a lane of its group;
    // the window below from the scratch, all reads before the writes
    {
      int32_t* Te = T + group() * kProdWords;
      const int p0 = kSpan * chunk();
      int32_t x[kSpan + 3];
      if (p0 > 0) {
        const int4 w = *reinterpret_cast<const int4*>(Te + p0 - 4);
        x[0] = w.y; x[1] = w.z; x[2] = w.w;
      } else {
        x[0] = x[1] = x[2] = 0;
      }
#pragma unroll
      for (int q = 0; q < kSpan / 4; ++q) {
        const int4 v = reinterpret_cast<const int4*>(Te + p0)[q];
        x[3 + 4 * q] = v.x; x[4 + 4 * q] = v.y; x[5 + 4 * q] = v.z; x[6 + 4 * q] = v.w;
      }
      passes(x);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kSpan / 4; ++q) {
        int32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = p0 + 4 * q + e < 100 ? x[3 + 4 * q + e] : 0;
        reinterpret_cast<int4*>(Te + p0)[q] = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncwarp();

    // 3. the fold: B column n = element n (< K) of quad group qg = n, rows
    // 2qt (+1), 2qt + 8 (+9) of k-step ks: positions NL + 16ks + 2qt …
    uint32_t hb[4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hb[ks][0] = hb[ks][1] = 0;
      if (qg < K) {
        const int32_t* t = T + qg * kProdWords + NL + 16 * ks + 2 * qt;
        hb[ks][0] = pack_h2(t[0], t[1]);
        hb[ks][1] = pack_h2(t[8], t[9]);
      }
    }
    float fo[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint4 fa = f.frag[(mt * 4 + ks) * 32 + lane];
        mma(fo[mt], fa.x, fa.y, fa.z, fa.w, hb[ks][0], hb[ks][1]);
      }
    }
    // D rows 16mt + qg (+ 8) of columns 2qt, 2qt + 1: digits of elements
    // 2qt and 2qt + 1
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 2 * qt + c;
      if (n < K) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          F[n * kFoldWords + 16 * mt + qg] = __float2int_rn(fo[mt][c]);
          F[n * kFoldWords + 16 * mt + qg + 8] = __float2int_rn(fo[mt][2 + c]);
        }
      }
    }
    __syncwarp();

    // 4. this lane's digits: the carried low digits plus the fold's
    const int p0 = own();
    int32_t t[kDigits], fv[kDigits];
    ld<kDigits>(T + group() * kProdWords + p0, t);
    ld<kDigits>(F + group() * kFoldWords + p0, fv);
#pragma unroll
    for (int m = 0; m < kDigits; ++m) out[m] = p0 + m < NL ? t[m] + fv[m] : 0;
  }
};

}  // namespace hb_mxu
