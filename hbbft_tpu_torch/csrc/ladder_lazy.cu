// Whole lazy scalar-mul ladder for Hopper (sm_90a): one launch runs every
// step of a batch of G1 or G2 ladders, one block of several warps per row.
//
// Replaces: hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy (a jax.lax.fori_loop
// over point_double (dbl-2009-l), point_add_raw (add-2007-bl), three
// point_selects and the infinity flag, MSB first), with the Pallas multiply
// of hbbft_tpu/ops/pallas_fp.py :: fp_mul_lazy_pallas run inside the kernel
// as fp_lazy.cuh's warp-cooperative product.  Digit-exact and inf-exact with
// the port's plain stepwise ladder (ops/gcurve.py :: scalar_mul_lazy_plain).
//
// Inputs: the base point's X, Y, Z as int32 (NL=30, W) columns of 13-bit
// digits (W = R for G1; W = 2R for G2, [re | im]: row r's real part in
// column r, its imaginary part in column R + r), the (R, nbits) int32 bits,
// little-endian, and base_inf (R bytes).  Outputs: X, Y, Z in the same
// layout and inf (R bytes).
//
// What bounds it on this card: per row and step it does ~125k (G1) or
// ~430k (G2) int32 operations on a few KB of state, so it is bound by
// operations, never by memory; and since a step's field operations form
// chains (a product feeds a difference feeds a product), by their latency.
//
// Design.  A step is a DAG of lazy Fp operations (47 for G1, 189 for G2)
// whose longest chain is a fifth (G2) to two fifths (G1) of its work.  One
// block of 3 (G1) or 8 (G2) warps runs one row, through the step machinery
// the windowed kernel runs K rows on (ladder_steps.cuh, at K = 1): each
// warp walks its own list of operations from the static schedule in
// ladder_schedule.h (generated by ops/ladder_schedule.py: list scheduling,
// longest path first), waits for the flags of the operands other warps
// compute, computes, stores and raises its destination's flag; the step
// reads one accumulator set and writes the other and ends at a block
// barrier.  Operations of the base point alone (Z2², the Karatsuba sums of
// base coordinates) run once, in a prologue.  The windowed kernel is the
// faster at every batch size measured, so no path runs this one; it stays
// held against its plain version.
//
// Constant time: every step runs the same operations, the addition
// whatever the bit, as the reference does; the bit and the inf flags are
// row-uniform registers and the selects are predicated moves, so no branch
// and no address depends on the secret scalar.  The 132-step loop is not
// unrolled.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_lazy.cuh"
#include "ladder_schedule.h"
#include "ladder_steps.cuh"

namespace {

using namespace hb_ladder;

constexpr int K = 1;  // one row a block
using Fd = hb::LazyField<K>;

template <class S, bool kFp2>
__global__ void __launch_bounds__(S::kWarps * 32)
ladder_lazy_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                   const uint8_t* __restrict__ base_inf,
                   const int32_t* __restrict__ fold, const int32_t* __restrict__ subc,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, uint8_t* __restrict__ out_inf,
                   int R, int nbits) {
  __shared__ __align__(16) int32_t rows[S::kSlots * hb::kRowWords];  // A, B, temporaries
  __shared__ __align__(16) int32_t base[S::kEntry * hb::kRowWords];
  __shared__ __align__(16) int32_t scratch[S::kWarps][hb::scratch_words<K>()];
  __shared__ int flag[S::kFlags];

  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x;  // one row per block
  for (int i = threadIdx.x; i < S::kFlags; i += blockDim.x) flag[i] = 0;
  hb::zero_scratch<K>(scratch[warp]);
  load_point<Fd, S, kFp2>(base, warp, px, py, pz, R, r);
  zero_rows<Fd, S>(rows, S::kAcc, warp);  // A: acc = ∞
  __syncthreads();
  hb::FieldLane<K> f;
  hb::load_field<K>(f, fold, subc, nullptr);

  const bool binf = base_inf[r] != 0;
  const int32_t* rbits = bits + static_cast<size_t>(r) * nbits;
  bool inf = true;
  // phase 0: the base point's own operations, once (warp 0); then a step a
  // bit, MSB first, reading one accumulator set and writing the other (one
  // call of run_list: see ladder_steps.cuh)
#pragma unroll 1
  for (int ph = 0; ph <= nbits; ++ph) {
    const bool bit = ph > 0 && rbits[nbits - ph] != 0;
    const int table_id = ph == 0 ? hb_sched::kPrologue
                                 : ((ph & 1) ? hb_sched::kStepAB : hb_sched::kStepBA);
    const int b0 = list_bound<kFp2>(table_id, warp, 0);
    const int b1 = (ph > 0 || warp == 0) ? list_bound<kFp2>(table_id, warp, 1) : b0;
    run_list<Fd, S, kFp2>(b0, b1, {rows, base, base + S::kAcc * hb::kRowWords}, scratch[warp],
                         flag, f, bit, inf, binf, ph + 1);
    // acc = ∞: acc + base = base; base = ∞: stays acc
    if (ph > 0) inf = bit ? (inf && binf) : inf;
    __syncthreads();
  }

  // nbits steps: the last wrote B if nbits is odd, else A
  store_point<Fd, S, kFp2>(rows + (nbits & 1) * S::kAcc * hb::kRowWords, warp, ox, oy, oz, R, r);
  if (threadIdx.x == 0) out_inf[r] = inf ? 1 : 0;
}

}  // namespace

extern "C" int hb_ladder_lazy(const void* px, const void* py, const void* pz,
                              const void* bits, const void* base_inf,
                              const void* fold, const void* subc,
                              void* ox, void* oy, void* oz, void* out_inf,
                              int R, int nbits, int fp2, void* stream) {
  const auto kernel = fp2 ? &ladder_lazy_kernel<hb_sched::G2, true>
                          : &ladder_lazy_kernel<hb_sched::G1, false>;
  const int threads = 32 * (fp2 ? hb_sched::G2::kWarps : hb_sched::G1::kWarps);
  kernel<<<R, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz,
      (const int32_t*)bits, (const uint8_t*)base_inf,
      (const int32_t*)fold, (const int32_t*)subc,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
