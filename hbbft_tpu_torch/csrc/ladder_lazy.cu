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
// block of 3 (G1) or 8 (G2) warps runs one row: every value of the step has
// a 32-digit slot in shared memory and a ready flag, each warp walks its
// own list of operations from the static schedule in ladder_schedule.h
// (generated by ops/ladder_schedule.py: list scheduling, longest path
// first), waits for the flags of the operands other warps compute,
// computes, stores and raises its destination's flag; the step ends at a
// block barrier.  The epoch's 256 G1 and 128 G2 rows so become 768 and
// 1024 warps on the card's 528 schedulers.  Inside an operation the
// carries run on shuffled windows (fp_lazy.cuh).  Operations of the base
// point alone (Z2², the Karatsuba sums of base coordinates) run once, in a
// prologue.
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

namespace {

using hb::NL;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// Every lane waits until slot `s` holds this step's value, where `wait`
// says another warp computes it (accumulator, base and prologue slots are
// written before a barrier; this warp's own values by program order).
__device__ __forceinline__ void wait_slot(const int* flag, int s, bool wait, int step) {
  if (wait) {
    while (ld_acquire(flag + s) < step) {
      __nanosleep(20);  // leave the issue slots to the warps that compute
    }
  }
}

// One operation of the schedule on this warp; SEL writes the accumulator.
__device__ __forceinline__ void run_op(hb_sched::Op op, int32_t (*sv)[32], int32_t* scratch,
                                       const hb::FieldLane& f, bool bit, bool inf, bool binf) {
  const int l = hb::lane_id();
  if (op.kind == hb_sched::SEL) {
    const int32_t base = sv[op.a][l], d = sv[op.b][l], s = sv[op.c][l];
    const int32_t res = inf ? base : (binf ? d : s);
    sv[op.dst][l] = bit ? res : d;
    return;
  }
  int32_t x;
  if (op.kind == hb_sched::MUL) {
    x = hb::fp_mul_unsqueezed(sv[op.a], sv[op.b], scratch, f);
  } else if (op.kind == hb_sched::ADD) {
    x = sv[op.a][l] + sv[op.b][l];
  } else {
    x = hb::fp_sub_unsqueezed(sv[op.a][l], sv[op.b][l], f);
  }
  sv[op.dst][l] = hb::squeeze(x, f);
}

// column `col` of an (NL, W) digit tensor into a slot, 0 on lanes 30, 31
__device__ __forceinline__ void load_slot(int32_t* slot, const int32_t* __restrict__ p, int W,
                                          int col) {
  const int l = hb::lane_id();
  slot[l] = l < NL ? p[l * W + col] : 0;
}

__device__ __forceinline__ void store_slot(int32_t* __restrict__ p, int W, int col,
                                           const int32_t* slot) {
  const int l = hb::lane_id();
  if (l < NL) p[l * W + col] = slot[l];
}

// the schedule of G1 (kFp2 false) or G2, from constant memory
template <bool kFp2>
__device__ __forceinline__ hb_sched::Op prologue_op(int k) {
  return kFp2 ? hb_sched::kG2Prologue[k] : hb_sched::kG1Prologue[k];
}
template <bool kFp2>
__device__ __forceinline__ hb_sched::Op step_op(int k) {
  return kFp2 ? hb_sched::kG2Ops[k] : hb_sched::kG1Ops[k];
}
template <bool kFp2>
__device__ __forceinline__ int warp_begin(int w) {
  return kFp2 ? hb_sched::kG2Begin[w] : hb_sched::kG1Begin[w];
}

template <class S, bool kFp2>
__global__ void __launch_bounds__(S::kWarps * 32)
ladder_lazy_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                   const uint8_t* __restrict__ base_inf,
                   const int32_t* __restrict__ fold, const int32_t* __restrict__ subc,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   int32_t* __restrict__ oz, uint8_t* __restrict__ out_inf,
                   int R, int nbits) {
  __shared__ __align__(16) int32_t sv[S::kSlots][32];
  __shared__ __align__(16) int32_t scratch[S::kWarps][192];
  __shared__ int flag[S::kSlots];

  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x;  // one row per block
  hb::FieldLane f;
  hb::load_field(f, fold, subc);
  hb::zero_scratch(scratch[warp]);

  // slots: acc (zero), base, then the rest; flags 0
  const int32_t* coords[3] = {px, py, pz};
  for (int i = threadIdx.x; i < S::kSlots; i += blockDim.x) flag[i] = 0;
  for (int k = warp; k < S::kFirstTemp; k += S::kWarps) {
    if (k < S::kAcc) {
      sv[k][hb::lane_id()] = 0;
    } else if (k < 2 * S::kAcc) {
      const int e = k - S::kAcc;  // (x, y, z) × (re, im) order
      if (kFp2) {
        load_slot(sv[k], coords[e >> 1], 2 * R, (e & 1) ? R + r : r);
      } else {
        load_slot(sv[k], coords[e], R, r);
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // the base point's own operations, once
    for (int k = 0; k < S::kPrologue; ++k) {
      run_op(prologue_op<kFp2>(k), sv, scratch[0], f, false, false, false);
      __syncwarp();
    }
  }
  __syncthreads();

  const bool binf = base_inf[r] != 0;
  const int32_t* rbits = bits + static_cast<size_t>(r) * nbits;
  bool inf = true;
  const int b0 = warp_begin<kFp2>(warp), b1 = warp_begin<kFp2>(warp + 1);
#pragma unroll 1
  for (int i = nbits - 1, step = 1; i >= 0; --i, ++step) {  // MSB first
    const bool bit = rbits[i] != 0;
#pragma unroll 1
    for (int k = b0; k < b1; ++k) {
      const hb_sched::Op op = step_op<kFp2>(k);
      wait_slot(flag, op.a, op.wait & 1, step);
      wait_slot(flag, op.b, op.wait & 2, step);
      wait_slot(flag, op.c, op.wait & 4, step);
      __syncwarp();
      run_op(op, sv, scratch[warp], f, bit, inf, binf);
      __syncwarp();
      if (op.kind != hb_sched::SEL && hb::lane_id() == 0) st_release(flag + op.dst, step);
    }
    // acc = ∞: acc + base = base; base = ∞: stays acc
    inf = bit ? (inf && binf) : inf;
    __syncthreads();
  }

  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    int32_t* outs[3] = {ox, oy, oz};
    if (kFp2) {
      store_slot(outs[k >> 1], 2 * R, (k & 1) ? R + r : r, sv[k]);
    } else {
      store_slot(outs[k], R, r, sv[k]);
    }
  }
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
