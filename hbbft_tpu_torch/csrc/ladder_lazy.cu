// Whole lazy scalar-mul ladder for Hopper (sm_90a): one launch runs every
// step of a batch of G1 or G2 ladders, one warp per row.
//
// Replaces: hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy (a jax.lax.fori_loop
// over point_double (dbl-2009-l), point_add_raw (add-2007-bl), three
// point_selects and the infinity flag, MSB first), with the Pallas multiply
// of hbbft_tpu/ops/pallas_fp.py :: fp_mul_lazy_pallas run inside the kernel
// as fp_lazy.cuh's warp-cooperative fp_mul.  Digit-exact and inf-exact with the
// port's plain stepwise ladder (ops/gcurve.py :: scalar_mul_lazy_plain).
//
// Inputs: the base point's X, Y, Z as int32 (NL=30, W) columns of 13-bit
// digits (W = R for G1; W = 2R for G2, [re | im]: row r's real part in
// column r, its imaginary part in column R + r), the (R, nbits) int32 bits,
// little-endian, and base_inf (R bytes).  Outputs: X, Y, Z in the same
// layout and inf (R bytes).
//
// What bounds it on this card: per row and step it does ~177k (G1) or
// ~600k (G2) int32 operations on a few hundred bytes of state, so it is
// bound by operations, never by memory.  The design keeps the accumulator,
// the base and every temporary in registers (one digit a lane) across all
// steps: nothing goes through device memory between steps, and one launch
// replaces the ~10^6 small launches of the stepwise ladder.  One warp per
// row spreads the epoch's 256 G1 rows over 256 warps (one block each), so
// the ladder reaches most of the 132 SMs; a row's bit and inf flag are
// warp-uniform, so the selects are plain predicated moves and no branch
// diverges.  Every step computes the addition whatever the bit, as the
// reference does, so the time does not depend on the secret scalar.
// The 132-step loop is not unrolled (only the limb loops are).

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_lazy.cuh"

namespace {

using hb::Fp;
using hb::Fp2;
using hb::NL;

template <class E>
struct Point {
  E x, y, z;
};

// a·2 by one addition, as the plain _dbl_small(o, a, 1)
template <class E>
__device__ __forceinline__ E dbl(E a) {
  return hb::add(a, a);
}

template <class E>
__device__ __forceinline__ Point<E> point_double(const Point<E>& p) {
  using hb::add;
  using hb::mul;
  using hb::sqr;
  using hb::sub;
  const E a = sqr(p.x);
  const E b = sqr(p.y);
  const E c = sqr(b);
  E d = sub(sqr(add(p.x, b)), add(a, c));
  d = add(d, d);
  const E e = add(add(a, a), a);
  const E f = sqr(e);
  const E x3 = sub(f, add(d, d));
  const E y3 = sub(mul(e, sub(d, x3)), dbl(dbl(dbl(c))));
  const E z3 = mul(add(p.y, p.y), p.z);
  return {x3, y3, z3};
}

template <class E>
__device__ __forceinline__ Point<E> point_add_raw(const Point<E>& p1, const Point<E>& p2) {
  using hb::add;
  using hb::mul;
  using hb::sqr;
  using hb::sub;
  const E z1z1 = sqr(p1.z);
  const E z2z2 = sqr(p2.z);
  const E u1 = mul(p1.x, z2z2);
  const E u2 = mul(p2.x, z1z1);
  const E s1 = mul(mul(p1.y, p2.z), z2z2);
  const E s2 = mul(mul(p2.y, p1.z), z1z1);
  const E h = sub(u2, u1);
  const E r = sub(s2, s1);
  const E i = sqr(add(h, h));
  const E j = mul(h, i);
  const E r2 = add(r, r);
  const E v = mul(u1, i);
  const E x3 = sub(sub(sqr(r2), j), add(v, v));
  const E y3 = sub(mul(r2, sub(v, x3)), dbl(mul(s1, j)));
  const E z3 = mul(dbl(mul(p1.z, p2.z)), h);
  return {x3, y3, z3};
}

// column `col` of an (NL, W) digit tensor: digit l on lane l
__device__ __forceinline__ Fp load_fp(const int32_t* __restrict__ p, int W, int col) {
  const int l = hb::lane_id();
  return {l < NL ? p[l * W + col] : 0};
}

__device__ __forceinline__ void store_fp(int32_t* __restrict__ p, int W, int col, Fp v) {
  const int l = hb::lane_id();
  if (l < NL) p[l * W + col] = v.d;
}

__device__ __forceinline__ void load(Fp& v, const int32_t* p, int R, int r) {
  v = load_fp(p, R, r);
}
__device__ __forceinline__ void load(Fp2& v, const int32_t* p, int R, int r) {
  v = {load_fp(p, 2 * R, r), load_fp(p, 2 * R, R + r)};
}
__device__ __forceinline__ void store(int32_t* p, int R, int r, Fp v) {
  store_fp(p, R, r, v);
}
__device__ __forceinline__ void store(int32_t* p, int R, int r, Fp2 v) {
  store_fp(p, 2 * R, r, v.re);
  store_fp(p, 2 * R, R + r, v.im);
}

template <class E>
__global__ void __launch_bounds__(32)
ladder_lazy_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                   const uint8_t* __restrict__ base_inf,
                   const int32_t* __restrict__ fold, const int32_t* __restrict__ subc,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, uint8_t* __restrict__ out_inf,
                   int R, int nbits) {
  hb::stage_consts(fold, subc);
  const int r = blockIdx.x;  // one warp, one row
  Point<E> base;
  load(base.x, px, R, r);
  load(base.y, py, R, r);
  load(base.z, pz, R, r);
  const bool binf = base_inf[r] != 0;
  const int32_t* rbits = bits + static_cast<size_t>(r) * nbits;

  Point<E> acc = {E{}, E{}, E{}};
  bool inf = true;
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {  // MSB first
    const Point<E> d = point_double(acc);  // doubling keeps finiteness (odd order)
    const Point<E> s = point_add_raw(d, base);
    const bool bit = rbits[i] != 0;
    // acc = ∞: acc + base = base; base = ∞: stays acc
    const Point<E> res = inf ? base : (binf ? d : s);
    acc = bit ? res : d;
    inf = bit ? (inf && binf) : inf;
  }

  store(ox, R, r, acc.x);
  store(oy, R, r, acc.y);
  store(oz, R, r, acc.z);
  if (hb::lane_id() == 0) out_inf[r] = inf ? 1 : 0;
}

}  // namespace

extern "C" int hb_ladder_lazy(const void* px, const void* py, const void* pz,
                              const void* bits, const void* base_inf,
                              const void* fold, const void* subc,
                              void* ox, void* oy, void* oz, void* out_inf,
                              int R, int nbits, int fp2, void* stream) {
  const auto kernel = fp2 ? &ladder_lazy_kernel<Fp2> : &ladder_lazy_kernel<Fp>;
  kernel<<<R, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz,
      (const int32_t*)bits, (const uint8_t*)base_inf,
      (const int32_t*)fold, (const int32_t*)subc,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
