// The step machinery the ladder kernels share (ladder_lazy.cu, the bitwise
// ladder; ladder_window.cu, the 4-bit windowed one).
//
// Every value of a step has a 32-digit slot in shared memory (one 13-bit
// digit a lane, lanes 30 and 31 zero) and a ready flag.  A table of the
// static schedule (ladder_schedule.h, generated by ops/ladder_schedule.py)
// gives each warp of the row's block an ordered list of lazy Fp operations;
// a warp waits for the flags of the operands other warps compute, computes
// with fp_lazy.cuh's warp-cooperative field, stores, and raises its
// destination's flag with the step's number.  Flags only grow, so a flag
// left from an earlier step never passes for this one.  A step ends at a
// block barrier.

#pragma once

#include <cstdint>

#include "fp_lazy.cuh"
#include "ladder_schedule.h"

namespace hb_ladder {

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

// Row r's slots: the accumulator zero, the base point from the (NL, W)
// coordinate columns (W = R for G1; W = 2R for G2, [re | im]), in
// (x, y, z) × (re, im) order; the caller runs the prologue after a barrier.
template <class S, bool kFp2>
__device__ __forceinline__ void load_row(int32_t (*sv)[32], int warp, const int32_t* px,
                                         const int32_t* py, const int32_t* pz, int R, int r) {
  const int32_t* coords[3] = {px, py, pz};
  for (int k = warp; k < 2 * S::kAcc; k += S::kWarps) {
    if (k < S::kAcc) {
      sv[k][hb::lane_id()] = 0;
    } else {
      const int e = k - S::kAcc;
      if (kFp2) {
        load_slot(sv[k], coords[e >> 1], 2 * R, (e & 1) ? R + r : r);
      } else {
        load_slot(sv[k], coords[e], R, r);
      }
    }
  }
}

// The accumulator slots into row r of the output columns.
template <class S, bool kFp2>
__device__ __forceinline__ void store_row(int32_t (*sv)[32], int warp, int32_t* ox, int32_t* oy,
                                          int32_t* oz, int R, int r) {
  int32_t* outs[3] = {ox, oy, oz};
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    if (kFp2) {
      store_slot(outs[k >> 1], 2 * R, (k & 1) ? R + r : r, sv[k]);
    } else {
      store_slot(outs[k], R, r, sv[k]);
    }
  }
}

// The tables of G1 (kFp2 false) or G2 from constant memory: the prologue,
// and the step (kStep), double-only (kDbl) and add-the-base (kAddp) lists
enum Table { kStep, kDbl, kAddp };

template <bool kFp2>
__device__ __forceinline__ hb_sched::Op prologue_op(int k) {
  return kFp2 ? hb_sched::kG2Prologue[k] : hb_sched::kG1Prologue[k];
}

template <bool kFp2, Table T>
__device__ __forceinline__ hb_sched::Op table_op(int k) {
  if (T == kStep) return kFp2 ? hb_sched::kG2Ops[k] : hb_sched::kG1Ops[k];
  if (T == kDbl) return kFp2 ? hb_sched::kG2DblOps[k] : hb_sched::kG1DblOps[k];
  return kFp2 ? hb_sched::kG2AddpOps[k] : hb_sched::kG1AddpOps[k];
}

template <bool kFp2, Table T>
__device__ __forceinline__ int table_begin(int w) {
  if (T == kStep) return kFp2 ? hb_sched::kG2Begin[w] : hb_sched::kG1Begin[w];
  if (T == kDbl) return kFp2 ? hb_sched::kG2DblBegin[w] : hb_sched::kG1DblBegin[w];
  return kFp2 ? hb_sched::kG2AddpBegin[w] : hb_sched::kG1AddpBegin[w];
}

// the slot that holds result `k` of a table without selects
template <bool kFp2, Table T>
__device__ __forceinline__ int table_out(int k) {
  if (T == kDbl) return kFp2 ? hb_sched::kG2DblOut[k] : hb_sched::kG1DblOut[k];
  return kFp2 ? hb_sched::kG2AddpOut[k] : hb_sched::kG1AddpOut[k];
}

// This warp's list of table T for step number `step` (the caller ends the
// step with a block barrier).
template <bool kFp2, Table T>
__device__ __forceinline__ void run_table(int warp, int32_t (*sv)[32], int32_t* scratch,
                                          int* flag, const hb::FieldLane& f, bool bit, bool inf,
                                          bool binf, int step) {
  const int b0 = table_begin<kFp2, T>(warp), b1 = table_begin<kFp2, T>(warp + 1);
#pragma unroll 1
  for (int k = b0; k < b1; ++k) {
    const hb_sched::Op op = table_op<kFp2, T>(k);
    wait_slot(flag, op.a, op.wait & 1, step);
    wait_slot(flag, op.b, op.wait & 2, step);
    wait_slot(flag, op.c, op.wait & 4, step);
    __syncwarp();
    run_op(op, sv, scratch, f, bit, inf, binf);
    __syncwarp();
    if (op.kind != hb_sched::SEL && hb::lane_id() == 0) st_release(flag + op.dst, step);
  }
}

// The prologue on one warp: the base block's own operations, on the block
// whose slot s is sv[s] (slots kAcc .. kFirstTemp − 1).
template <bool kFp2, int kPrologue>
__device__ __forceinline__ void run_prologue(int32_t (*sv)[32], int32_t* scratch,
                                             const hb::FieldLane& f) {
#pragma unroll 1
  for (int k = 0; k < kPrologue; ++k) {
    run_op(prologue_op<kFp2>(k), sv, scratch, f, false, false, false);
    __syncwarp();
  }
}

}  // namespace hb_ladder
