// Whole 4-bit windowed lazy scalar-mul ladder over the 8-bit-digit field,
// for Hopper (sm_90a): one launch runs every window of a batch of G1 or G2
// ladders, one warp a row, the field's two products on the tensor cores.
//
// Replaces: hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy_window over
// MXU_FP_OPS / MXU_FP2_OPS (an XLA program on the TPU, no Pallas): the
// table [P, 2P, …, 15P], then per 4-bit window, most significant first, 4
// point_doubles and one point_add_raw of the entry the window selects,
// infinity as a flag; its field is hbbft_tpu/ops/fp381_mxu.py, whose
// fp_mul (:178) runs the digit convolution (:159 _conv_mxu, a
// (B, 2401) @ (2401, 97) one-hot matmul) and the fold ((B, 51) @ (51, 49))
// on the TPU's matrix unit, the carries and the squeeze (:136) on its
// vector unit.  Digit-exact and inf-exact with the port's plain version
// (ops/gcurve.py :: scalar_mul_lazy_window_plain over ops/fp381_mxu.py).
//
// Inputs (int32, column layout, NL = 49 digits of 8 bits): px, py, pz
// (NL, R) for G1, (NL, 2R) [re | im] for G2; bits (R, nbits) little-endian,
// nbits a multiple of 4; base_inf uint8 (R,).  Outputs in the same layout,
// out_inf uint8 (R,).  frag: the fold matrix as mma A fragments (uint32
// pairs of f16, [m-tile][k-step][lane][4], ops/ladder_mxu.py); sq: the
// three squeeze rows (3, NL); subc: the sub constant (NL,).
//
// What bounds it on this card: a chain of dependent field operations a row
// (about 1 600 products and 2 100 sums a G1 row at 132 bits, three times the
// products for G2), each a few hundred instructions whose latency no other
// work of the row hides; the tensor-core work (4 + 16 mma a product) and
// the bytes are far below it.  A simple design: one warp a row, the point
// formulas in the plain version's order, every value in shared memory.
//
// The product a·b (fmul), for digits in [0, 2^11] (f16 holds them
// exactly; the ladder's stay ≤ 384):
//   1. The convolution t_k = Σ a_i·b_j (i + j = k), 97 positions, as one
//      m16n8k16 product per 16 positions of a Toeplitz block:
//      D[m][q] = Σ_c a_{m−c}·b_{16q+c} (m < 64, c < 16, q < 4), so that
//      t_k = Σ_q D[k − 16q][q].  A[m][c] = a_{m−c} is read from a staging
//      row of f16 pairs (a_y, a_{y−1}); B's column q is digits 16q … 16q+15
//      of b; a warp's 4 tiles (m < 64) give the 4 × 64 block, and a lane of
//      quad 0 or 1 adds its two columns' terms, one shuffle the quad pair's.
//      Every sum is ≤ 49·256² < 2^22 < 2^24: exact in f32.
//   2. The rough carry over 100 positions (97 and 3 carry positions; the
//      top carry dropped), 4 digits a lane, one shuffle a pass.
//   3. The fold of the 51 digits from position 49 through 2^(8(49+m)) mod
//      p: the (64 × 64 padded) fold matrix as A against the high digits as
//      B's column 0, 4 × 4 m16n8k16 products; sums ≤ 51·384·255 < 2^23.
//   4. The squeeze on the ALU, 2 digits a lane: three carry positions, a
//      rough carry, three rounds folding positions 49 … 51 through the
//      squeeze rows.
// Sums and differences are the squeeze of a + b or a + (510 − b) + subc.
// A field element is a row of 64 words: digits 0 … 48, zeros 49 … 63.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNL = 49;
constexpr int kRow = 64;     // words of an element's row
constexpr int kWindow = 4;
constexpr int kEntries = (1 << kWindow) - 1;  // P … 15P

// Shared memory of a block (one warp, one row), in 32-bit words: the fold
// matrix's A fragments, the squeeze rows and the sub constant at a lane's
// positions (row p of 64), fmul's staging rows, then the element rows.
constexpr int kFrag = 0;                   // [m-tile][k-step][lane] uint4
constexpr int kSq = kFrag + 16 * 32 * 4;   // (3, 64), 0 from position 49
constexpr int kSubc = kSq + 3 * kRow;      // (64,), 0 from position 49
constexpr int kPairs = kSubc + kRow;       // 80 f16 pairs (a_y, a_{y−1}), y = −16 … 63
constexpr int kT = kPairs + 80;            // the product's positions: 0 … 99 used, 100 … 127 stay 0
constexpr int kF = kT + 128;               // the fold's 64 output positions
constexpr int kRows = kF + 64;             // the element rows

// elements, in units of one field element (Fp: one row, Fp2: two, re then im)
constexpr int kAcc = 3 * kEntries;  // the table is elements 0 … 44
constexpr int kAdded = kAcc + 3;
constexpr int kTmp = kAdded + 3;
constexpr int kTmps = 14;
constexpr int kElements = kTmp + kTmps;
constexpr int kFp2Scratch = 6;  // rows of fp2_mul's and fp2_sqr's own values

template <bool kFp2>
__host__ __device__ constexpr int rows_per_block() {
  return kFp2 ? 2 * kElements + kFp2Scratch : kElements;
}
template <bool kFp2>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(int32_t) * (kRows + rows_per_block<kFp2>() * kRow);
}

__device__ __forceinline__ int32_t* shared() {
  extern __shared__ __align__(16) int32_t smem[];
  return smem;
}
__device__ __forceinline__ int32_t* row(int r) { return shared() + kRows + r * kRow; }
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t pack_h2(int lo, int hi) {
  __half2 h = __halves2half2(__int2half_rn(lo), __int2half_rn(hi));
  return *reinterpret_cast<uint32_t*>(&h);
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

// three rough passes over 2 digits a lane (positions 2·lane, 2·lane + 1);
// the carry out of position 63 is dropped
__device__ __forceinline__ void carry2(int& v0, int& v1) {
  const int lane = lane_id();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int c0 = v0 >> 8, c1 = v1 >> 8;
    v0 &= 255;
    v1 = (v1 & 255) + c0;
    const int in = __shfl_up_sync(kFull, c1, 1);
    v0 += lane ? in : 0;
  }
}

// _squeeze: positions ≥ 49 of the input are 0 (the three carry positions);
// the result's positions ≥ 49 are garbage, never stored
__device__ __forceinline__ void squeeze(int& v0, int& v1) {
  const int p0 = 2 * lane_id();
  const int32_t* sq = shared() + kSq;
  carry2(v0, v1);
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int t0 = __shfl_sync(kFull, v1, 24);  // position 49
    const int t1 = __shfl_sync(kFull, v0, 25);  // 50
    const int t2 = __shfl_sync(kFull, v1, 25);  // 51
    v0 = p0 < kNL ? v0 + t0 * sq[p0] + t1 * sq[kRow + p0] + t2 * sq[2 * kRow + p0] : 0;
    v1 = p0 + 1 < kNL
             ? v1 + t0 * sq[p0 + 1] + t1 * sq[kRow + p0 + 1] + t2 * sq[2 * kRow + p0 + 1]
             : 0;
    carry2(v0, v1);
  }
}

__device__ __forceinline__ int2 load2(int r) {
  return reinterpret_cast<const int2*>(row(r))[lane_id()];
}

__device__ __forceinline__ void store2(int r, int v0, int v1) {
  const int p0 = 2 * lane_id();
  reinterpret_cast<int2*>(row(r))[lane_id()] =
      make_int2(p0 < kNL ? v0 : 0, p0 + 1 < kNL ? v1 : 0);
}

// Each lane reads and writes only its own two positions in fadd, fsub and
// copies; fmul reads across lanes after a __syncwarp.
__device__ __noinline__ void fadd(int o, int a, int b) {
  const int2 x = load2(a), y = load2(b);
  int v0 = x.x + y.x, v1 = x.y + y.y;
  squeeze(v0, v1);
  store2(o, v0, v1);
}

__device__ __noinline__ void fsub(int o, int a, int b) {
  const int p0 = 2 * lane_id();
  const int32_t* subc = shared() + kSubc;
  const int2 x = load2(a), y = load2(b);
  int v0 = p0 < kNL ? x.x + (510 - y.x) + subc[p0] : 0;
  int v1 = p0 + 1 < kNL ? x.y + (510 - y.y) + subc[p0 + 1] : 0;
  squeeze(v0, v1);
  store2(o, v0, v1);
}

__device__ __noinline__ void fmul(int o, int a, int b) {
  __syncwarp();
  int32_t* s = shared();
  uint32_t* pairs = reinterpret_cast<uint32_t*>(s + kPairs);
  int32_t* tb = s + kT;
  int32_t* fb = s + kF;
  const uint4* frag = reinterpret_cast<const uint4*>(s + kFrag);
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int32_t* ra = row(a);
  const int32_t* rb = row(b);
  // the staging row: pairs[y + 16] = (a_y, a_{y−1}), 0 outside 0 … 48
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int y = lane - 16 + 32 * k;
    if (k < 2 || lane < 16) {
      const int lo = y >= 0 ? ra[y] : 0;
      const int hi = y >= 1 ? ra[y - 1] : 0;
      pairs[y + 16] = pack_h2(lo, hi);
    }
  }
  uint32_t b0 = 0, b1 = 0;
  if (g < 4) {  // B column q = g: digits 16q … 16q + 15 of b
    const int j = 16 * g + 2 * t;
    b0 = pack_h2(rb[j], rb[j + 1]);
    b1 = pack_h2(rb[j + 8], rb[j + 9]);
  }
  __syncwarp();
  float d[4][4] = {};
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    // A[m][c] = a_{m−c}: rows g, g + 8 and columns 2t (+1), 2t + 8 (+9) of
    // tile mt are the pairs at x, x + 8, x − 8, x
    const int x = 16 * mt + g - 2 * t + 16;
    const uint32_t p = pairs[x];
    mma(d[mt], p, pairs[x + 8], pairs[x - 8], p, b0, b1);
  }
  // t at position 16u + 8h + g: D[16(u − q) + 8h + g][q] over q; quad lane
  // t holds columns 2t and 2t + 1 (t ≥ 2: the zero columns 4 … 7)
#pragma unroll
  for (int u = 0; u < 7; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s0 = 0.f, s1 = 0.f;
      if (u < 4) s0 += d[u][2 * h];
      if (u >= 1 && u <= 4) s0 += d[u - 1][2 * h + 1];
      if (u >= 2 && u <= 5) s1 += d[u - 2][2 * h];
      if (u >= 3) s1 += d[u - 3][2 * h + 1];
      float sum = t == 0 ? s0 : s1;
      sum += __shfl_xor_sync(kFull, sum, 1);
      if (t == 0) tb[16 * u + 8 * h + g] = __float2int_rn(sum);
    }
  }
  __syncwarp();
  // the rough carry over positions 0 … 99, 4 a lane
  int4 v = reinterpret_cast<int4*>(tb)[lane];
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int c0 = v.x >> 8, c1 = v.y >> 8, c2 = v.z >> 8, c3 = v.w >> 8;
    v.x &= 255;
    v.y = (v.y & 255) + c0;
    v.z = (v.z & 255) + c1;
    v.w = (v.w & 255) + c2;
    const int in = __shfl_up_sync(kFull, c3, 1);
    v.x += lane ? in : 0;
  }
  if (lane < 25) reinterpret_cast<int4*>(tb)[lane] = v;
  __syncwarp();
  // the fold: F (64 × 64, digit d × high position m) against the high
  // digits as column 0 of B (lanes 0 … 3); positions ≥ 100 read 0
  float f[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t h0 = 0, h1 = 0;
    if (g == 0) {
      const int k = kNL + 16 * ks + 2 * t;
      h0 = pack_h2(tb[k], tb[k + 1]);
      h1 = pack_h2(tb[k + 8], tb[k + 9]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint4 fa = frag[(mt * 4 + ks) * 32 + lane];
      mma(f[mt], fa.x, fa.y, fa.z, fa.w, h0, h1);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      fb[16 * mt + g] = __float2int_rn(f[mt][0]);
      fb[16 * mt + g + 8] = __float2int_rn(f[mt][2]);
    }
  }
  __syncwarp();
  const int p0 = 2 * lane;
  int v0 = p0 < kNL ? tb[p0] + fb[p0] : 0;
  int v1 = p0 + 1 < kNL ? tb[p0 + 1] + fb[p0 + 1] : 0;
  squeeze(v0, v1);
  store2(o, v0, v1);
  __syncwarp();  // the staging rows are free for the next product
}

__device__ __forceinline__ void copy_row(int o, int a) {
  reinterpret_cast<int2*>(row(o))[lane_id()] = load2(a);
}

// The field of a ladder over element indices (an Fp element is one row, an
// Fp2 element two: re at row 2e, im at 2e + 1); scratch rows after them.
template <bool kFp2>
struct Field;

template <>
struct Field<false> {
  static constexpr int kW = 1;
  __device__ static void add(int o, int a, int b) { fadd(o, a, b); }
  __device__ static void sub(int o, int a, int b) { fsub(o, a, b); }
  __device__ static void mul(int o, int a, int b) { fmul(o, a, b); }
  __device__ static void sqr(int o, int a) { fmul(o, a, a); }
  __device__ static void copy(int o, int a) { copy_row(o, a); }
};

template <>
struct Field<true> {
  static constexpr int kW = 2;
  static constexpr int kX = 2 * kElements;  // the scratch rows
  __device__ static void add(int o, int a, int b) {
    fadd(2 * o, 2 * a, 2 * b);
    fadd(2 * o + 1, 2 * a + 1, 2 * b + 1);
  }
  __device__ static void sub(int o, int a, int b) {
    fsub(2 * o, 2 * a, 2 * b);
    fsub(2 * o + 1, 2 * a + 1, 2 * b + 1);
  }
  // Karatsuba in the reference's order: t0 = a0·b0, t1 = a1·b1,
  // t2 = (a0 + a1)(b0 + b1); re = t0 − t1, im = t2 − (t0 + t1)
  __device__ static void mul(int o, int a, int b) {
    const int sa = kX, sb = kX + 1, t0 = kX + 2, t1 = kX + 3, t2 = kX + 4, u = kX + 5;
    fadd(sa, 2 * a, 2 * a + 1);
    fadd(sb, 2 * b, 2 * b + 1);
    fmul(t0, 2 * a, 2 * b);
    fmul(t1, 2 * a + 1, 2 * b + 1);
    fmul(t2, sa, sb);
    fsub(2 * o, t0, t1);
    fadd(u, t0, t1);
    fsub(2 * o + 1, t2, u);
  }
  // (a0 + a1)(a0 − a1) and a0·a1; im = t1 + t1
  __device__ static void sqr(int o, int a) {
    const int s = kX, d = kX + 1, t1 = kX + 2;
    fadd(s, 2 * a, 2 * a + 1);
    fsub(d, 2 * a, 2 * a + 1);
    fmul(t1, 2 * a, 2 * a + 1);
    fmul(2 * o, s, d);
    fadd(2 * o + 1, t1, t1);
  }
  __device__ static void copy(int o, int a) {
    copy_row(2 * o, 2 * a);
    copy_row(2 * o + 1, 2 * a + 1);
  }
};

// o ← 2·i (dbl-2009-l, the plain point_double's operations); o may be i
template <class Fd>
__device__ __noinline__ void point_double(int o, int i) {
  const int X = i, Y = i + 1, Z = i + 2;
  const int a = kTmp, b = kTmp + 1, c = kTmp + 2, t = kTmp + 3, u = kTmp + 4, d = kTmp + 5,
            e = kTmp + 6, f = kTmp + 7;
  Fd::sqr(a, X);
  Fd::sqr(b, Y);
  Fd::sqr(c, b);
  Fd::add(t, X, b);
  Fd::sqr(t, t);
  Fd::add(u, a, c);
  Fd::sub(d, t, u);
  Fd::add(d, d, d);
  Fd::add(e, a, a);
  Fd::add(e, e, a);
  Fd::sqr(f, e);
  Fd::add(u, Y, Y);
  Fd::mul(o + 2, u, Z);  // z3 = 2y·z: the last read of Y and Z
  Fd::add(t, d, d);
  Fd::sub(o, f, t);  // x3 = f − 2d
  Fd::sub(t, d, o);
  Fd::mul(t, e, t);
  Fd::add(u, c, c);
  Fd::add(u, u, u);
  Fd::add(u, u, u);
  Fd::sub(o + 1, t, u);  // y3 = e·(d − x3) − 8c
}

// o ← p + q (add-2007-bl, the plain point_add_raw's operations); o is
// neither p nor q
template <class Fd>
__device__ __noinline__ void point_add_raw(int o, int p, int q) {
  const int X1 = p, Y1 = p + 1, Z1 = p + 2, X2 = q, Y2 = q + 1, Z2 = q + 2;
  const int z1z1 = kTmp, z2z2 = kTmp + 1, u1 = kTmp + 2, u2 = kTmp + 3, s1 = kTmp + 4,
            s2 = kTmp + 5, h = kTmp + 6, r = kTmp + 7, i = kTmp + 8, j = kTmp + 9,
            r2 = kTmp + 10, v = kTmp + 11, t = kTmp + 12, x = kTmp + 13;
  Fd::sqr(z1z1, Z1);
  Fd::sqr(z2z2, Z2);
  Fd::mul(u1, X1, z2z2);
  Fd::mul(u2, X2, z1z1);
  Fd::mul(s1, Y1, Z2);
  Fd::mul(s1, s1, z2z2);
  Fd::mul(s2, Y2, Z1);
  Fd::mul(s2, s2, z1z1);
  Fd::sub(h, u2, u1);
  Fd::sub(r, s2, s1);
  Fd::add(i, h, h);
  Fd::sqr(i, i);
  Fd::mul(j, h, i);
  Fd::add(r2, r, r);
  Fd::mul(v, u1, i);
  Fd::sqr(t, r2);
  Fd::sub(t, t, j);
  Fd::add(x, v, v);
  Fd::sub(o, t, x);  // x3 = r2² − j − 2v
  Fd::sub(t, v, o);
  Fd::mul(t, r2, t);
  Fd::mul(x, s1, j);
  Fd::add(x, x, x);
  Fd::sub(o + 1, t, x);  // y3 = r2·(v − x3) − 2·s1·j
  Fd::mul(t, Z1, Z2);
  Fd::add(t, t, t);
  Fd::mul(o + 2, t, h);  // z3 = 2·z1·z2·h
}

template <class Fd>
__device__ void copy_point(int o, int a) {
  for (int c = 0; c < 3; ++c) Fd::copy(o + c, a + c);
}

template <bool kFp2>
__global__ void __launch_bounds__(32)
ladder_mxu_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                  const uint8_t* __restrict__ base_inf, const int32_t* __restrict__ frag,
                  const int32_t* __restrict__ sq, const int32_t* __restrict__ subc,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  uint8_t* __restrict__ out_inf, int R, int nbits) {
  using Fd = Field<kFp2>;
  constexpr int kWords = kRows + rows_per_block<kFp2>() * kRow;
  int32_t* s = shared();
  const int r = blockIdx.x;
  const int lane = lane_id();
  for (int i = lane; i < kWords; i += 32) s[i] = 0;
  __syncwarp();
  for (int i = lane; i < kSq - kFrag; i += 32) s[kFrag + i] = frag[i];
  for (int p = lane; p < kNL; p += 32) {
    for (int m = 0; m < 3; ++m) s[kSq + m * kRow + p] = sq[m * kNL + p];
    s[kSubc + p] = subc[p];
  }
  // P into entry 0: coordinate c, part k (G2: re, im) of column r (+ R)
  const int width = kFp2 ? 2 * R : R;
  for (int p = lane; p < kNL; p += 32) {
    for (int k = 0; k < Fd::kW; ++k) {
      row(0 * Fd::kW + k)[p] = px[p * width + k * R + r];
      row(1 * Fd::kW + k)[p] = py[p * width + k * R + r];
      row(2 * Fd::kW + k)[p] = pz[p * width + k * R + r];
    }
  }
  __syncwarp();
  // the table: entry k − 1 = k·P by a doubling (k even) or P + (k − 1)·P
  for (int k = 2; k <= kEntries; ++k) {
    if (k % 2 == 0) {
      point_double<Fd>(3 * (k - 1), 3 * (k / 2 - 1));
    } else {
      point_add_raw<Fd>(3 * (k - 1), 3 * (k - 2), 0);
    }
  }
  const bool binf = base_inf[r] != 0;
  bool inf = true;  // the accumulator's rows start at 0
  const int32_t* rbits = bits + static_cast<size_t>(r) * nbits;
  for (int win = nbits / kWindow - 1; win >= 0; --win) {
    int idx = 0;
    for (int j = 0; j < kWindow; ++j) idx |= (rbits[kWindow * win + j] & 1) << j;
    for (int j = 0; j < kWindow; ++j) point_double<Fd>(kAcc, kAcc);
    const int entry = 3 * (idx > 0 ? idx - 1 : 0);
    point_add_raw<Fd>(kAdded, kAcc, entry);
    // acc = ∞: acc + entry = entry; base = ∞: acc stays; a zero window keeps it
    if (idx != 0) {
      if (inf) {
        copy_point<Fd>(kAcc, entry);
      } else if (!binf) {
        copy_point<Fd>(kAcc, kAdded);
      }
      inf = inf && binf;
    }
  }
  __syncwarp();
  for (int p = lane; p < kNL; p += 32) {
    for (int k = 0; k < Fd::kW; ++k) {
      ox[p * width + k * R + r] = row((kAcc + 0) * Fd::kW + k)[p];
      oy[p * width + k * R + r] = row((kAcc + 1) * Fd::kW + k)[p];
      oz[p * width + k * R + r] = row((kAcc + 2) * Fd::kW + k)[p];
    }
  }
  if (lane == 0) out_inf[r] = inf ? 1 : 0;
}

template <bool kFp2>
int launch(const void* px, const void* py, const void* pz, const void* bits,
           const void* base_inf, const void* frag, const void* sq, const void* subc, void* ox,
           void* oy, void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  if (R <= 0) return (int)cudaSuccess;
  ladder_mxu_kernel<kFp2><<<R, 32, smem_bytes<kFp2>(), stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)bits,
      (const uint8_t*)base_inf, (const int32_t*)frag, (const int32_t*)sq, (const int32_t*)subc,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

template <bool kFp2>
int info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, ladder_mxu_kernel<kFp2>);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ladder_mxu_kernel<kFp2>, 32,
                                                     smem_bytes<kFp2>());
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)smem_bytes<kFp2>();
  out[4] = 1;
  return (int)cudaSuccess;
}

}  // namespace

// The one entry point: every window of R ladders of nbits bits (a multiple
// of 4), G2 when fp2; returns the launch's cudaGetLastError().
extern "C" int hb_ladder_mxu(const void* px, const void* py, const void* pz, const void* bits,
                             const void* base_inf, const void* frag, const void* sq,
                             const void* subc, void* ox, void* oy, void* oz, void* out_inf,
                             int R, int nbits, int fp2, void* stream) {
  if (nbits % kWindow != 0) return (int)cudaErrorInvalidValue;
  return fp2 ? launch<true>(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf, R,
                            nbits, (cudaStream_t)stream)
             : launch<false>(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf, R,
                             nbits, (cudaStream_t)stream);
}

// The kernel's registers, local (spilled) bytes, blocks an SM, dynamic
// shared memory bytes and warps a block, into out[0 .. 5).
extern "C" int hb_ladder_mxu_info(int fp2, int* out) {
  return fp2 ? info<true>(out) : info<false>(out);
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
