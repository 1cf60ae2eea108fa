// The step machinery the ladder kernels share (ladder_lazy.cu, the bitwise
// ladder; ladder_window.cu, the 4-bit windowed one).
//
// A block runs K rows (K in {1, 2, 4}) side by side: every warp computes
// each of its operations for the K rows at once, 32/K lanes a row
// (fp_lazy.cuh), so the tables, flags, waits and barriers are paid once
// for K rows.  Every value of a step has a slot: a slot row in shared
// memory (K rows of 32 digits) and a ready flag.  A table of the static
// schedule (ladder_schedule.h, generated by ops/ladder_schedule.py) gives
// each warp of the block an ordered list of lazy Fp operations; a warp
// waits for the flags of the operands other warps compute, computes,
// stores, and raises its destination's flag.  A step ends at a block
// barrier.
//
// A slot id is a row of the block's two accumulator sets and temporaries;
// an operand flagged "base" is a row of the base block instead (Frame).  A
// table reads one accumulator set and writes the other (the generator
// emits both directions), and its base block may be any table entry — a
// different one for each of the K rows — with no copies.  A temporary
// slot may be written up to seven times in a step (the generator reuses it
// once every reader of its value has surely run): a write raises the flag
// to 8·step + its version, and a reader waits for 8·step + the version it
// reads.  Flags only grow, so a flag left from an earlier write never
// passes.

#pragma once

#include <cstdint>

#include "fp_lazy.cuh"
#include "ladder_schedule.h"

namespace hb_ladder {

using hb::NL;

constexpr int kVersionStride = 8;

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

// Every lane waits until slot `s` holds the value it reads, where `wait`
// says another warp computes it (in, base and out of an earlier step are
// written before a barrier; this warp's own values by program order).  A
// wait that outlasts 2^22 polls (over 80 ms; an operation takes
// microseconds) can only be a broken table: the kernel traps, so the
// launch fails instead of hanging.
constexpr int kMaxPolls = 1 << 22;

__device__ __forceinline__ void wait_slot(const int* flag, int s, bool wait, int need) {
  if (wait) {
    for (int polls = 0; ld_acquire(flag + s) < need; ++polls) {
      if (polls == kMaxPolls) __trap();
      __nanosleep(20);  // leave the issue slots to the warps that compute
    }
  }
}

// Where this lane's rows live: `rows` is slot row 0 of the block's
// accumulator sets and temporaries (slot s at rows + s·K·32); a base row s
// is the base point's coordinate s of `base` (s < kAcc: a table entry, each
// of the K rows its own) or the prologue's value s − kAcc of `pro`; all
// offset to this lane's row (group) of the K.
template <class S, int K>
struct Frame {
  int32_t* rows;
  int32_t* base;
  int32_t* pro;

  __device__ __forceinline__ int32_t* row(int s, bool is_base) const {
    int32_t* const from = is_base ? (s < S::kAcc ? base : pro - S::kAcc * K * hb::kRowWords) : rows;
    return from + s * (K * hb::kRowWords);
  }
};

// Slot row `first` of a block region, at this lane's row
template <int K>
__device__ __forceinline__ int32_t* rows_at(int32_t* region, int first) {
  return region + first * K * hb::kRowWords + hb::Lanes<K>::group() * hb::kRowWords;
}

// An op's operand k (0, 1, 2: a, b, c; 3: dst) is a base row
__device__ __forceinline__ bool is_base(const hb_sched::Op& op, int k) {
  return (op.wait >> (4 + k)) & 1;
}

// One operation of the schedule on this warp; SEL writes the next
// accumulator: acc = bit ? (inf ? base : (binf ? d : s)) : d.
template <class S, int K>
__device__ __forceinline__ void run_op(hb_sched::Op op, const Frame<S, K>& fr, int32_t* scratch,
                                       const hb::FieldLane<K>& f, bool bit, bool inf,
                                       bool binf) {
  using L = hb::Lanes<K>;
  const int own = L::at(L::chunk(), L::group());
  const int32_t* pa = fr.row(op.a, is_base(op, 0));
  const int32_t* pb = fr.row(op.b, is_base(op, 1));
  int32_t* pd = fr.row(op.dst, is_base(op, 3));
  int32_t x[K];
  if (op.kind == hb_sched::SEL) {
    int32_t base[K], d[K], s[K];
    hb::ld<K>(pa + own, base);
    hb::ld<K>(pb + own, d);
    hb::ld<K>(fr.row(op.c, is_base(op, 2)) + own, s);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int32_t res = inf ? base[m] : (binf ? d[m] : s[m]);
      x[m] = bit ? res : d[m];
    }
    hb::st<K>(pd + own, x);
    return;
  }
  if (op.kind == hb_sched::MUL) {
    hb::fp_mul_unsqueezed<K>(pa, pb, scratch, f, x);
  } else {
    int32_t a[K], b[K];
    hb::ld<K>(pa + own, a);
    hb::ld<K>(pb + own, b);
    if (op.kind == hb_sched::ADD) {
#pragma unroll
      for (int m = 0; m < K; ++m) x[m] = a[m] + b[m];
    } else {  // a − b (mod p), lazy: a + (2·MASK − b) + sub constant
#pragma unroll
      for (int m = 0; m < K; ++m) x[m] = a[m] + f.subk[m] - b[m];
    }
  }
  hb::squeeze<K>(x, f);
  __syncwarp();  // every lane's reads of the operands are done
  hb::st<K>(pd + own, x);
}

// Coordinate slot k of a row from the (NL, W) digit columns (W = R for G1;
// W = 2R for G2, [re | im]) into its slot row (this lane's row r; zeros
// where r ≥ R), and back.
template <int K, bool kFp2>
__device__ __forceinline__ int coord_col(int k, int R, int r) {
  return kFp2 ? ((k & 1) ? R + r : r) : r;
}

template <int K, bool kFp2>
__device__ __forceinline__ void load_coord(int32_t* row, const int32_t* __restrict__ p, int k,
                                           int R, int r) {
  using L = hb::Lanes<K>;
  const int W = kFp2 ? 2 * R : R, col = coord_col<K, kFp2>(k, R, r), p0 = K * L::chunk();
  int32_t v[K];
#pragma unroll
  for (int m = 0; m < K; ++m) v[m] = (r < R && p0 + m < NL) ? p[(p0 + m) * W + col] : 0;
  hb::st<K>(row + L::at(L::chunk(), L::group()), v);
}

template <int K, bool kFp2>
__device__ __forceinline__ void store_coord(int32_t* __restrict__ p, const int32_t* row, int k,
                                            int R, int r) {
  using L = hb::Lanes<K>;
  const int W = kFp2 ? 2 * R : R, col = coord_col<K, kFp2>(k, R, r), p0 = K * L::chunk();
  int32_t v[K];
  hb::ld<K>(row + L::at(L::chunk(), L::group()), v);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if (r < R && p0 + m < NL) p[(p0 + m) * W + col] = v[m];
  }
}

// The base point's coordinates into the first kAcc slot rows of `block`
// (row r of this lane; (x, y, z) × (re, im) order), a warp a slot
template <class S, int K, bool kFp2>
__device__ __forceinline__ void load_point(int32_t* block, int warp, const int32_t* px,
                                           const int32_t* py, const int32_t* pz, int R, int r) {
  const int32_t* coords[3] = {px, py, pz};
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    load_coord<K, kFp2>(rows_at<K>(block, k), coords[kFp2 ? k >> 1 : k], k, R, r);
  }
}

template <class S, int K, bool kFp2>
__device__ __forceinline__ void store_point(int32_t* block, int warp, int32_t* ox, int32_t* oy,
                                            int32_t* oz, int R, int r) {
  int32_t* outs[3] = {ox, oy, oz};
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    store_coord<K, kFp2>(outs[kFp2 ? k >> 1 : k], rows_at<K>(block, k), k, R, r);
  }
}

// the first n slot rows of `block` to zero, a warp a slot
template <class S, int K>
__device__ __forceinline__ void zero_rows(int32_t* block, int n, int warp) {
  for (int k = warp; k < n; k += S::kWarps) {
    for (int i = hb::lane_id(); i < K * hb::kRowWords; i += 32) block[k * K * hb::kRowWords + i] = 0;
  }
}

// The op list of table `table` (hb_sched::kStepAB, …, kPrologue) for
// `warp`: [begin, end) of the group's constant array
template <bool kFp2>
__device__ __forceinline__ int list_bound(int table, int warp, int end) {
  return kFp2 ? hb_sched::kG2Range[table][warp][end] : hb_sched::kG1Range[table][warp][end];
}

// version field of an op: 3 bits a source (a, b, c), then the destination
__device__ __forceinline__ int version(const hb_sched::Op& op, int k) {
  return (op.ver >> (3 * k)) & 7;
}

// Operations [b0, b1) of the group's table array on this warp, as step
// number `step` (the caller ends the step with a block barrier).  Each
// kernel calls it from one place only, so the field's code is in the
// binary once: several inlined copies would not fit the instruction cache
// together.
// The flag of slot s, or of base row s (a prologue value: the coordinates
// are never waited for), after the slots' flags
template <class S>
__device__ __forceinline__ int flag_of(int s, bool is_base) {
  return is_base ? S::kSlots + s - S::kAcc : s;
}

template <class S, int K, bool kFp2>
__device__ __forceinline__ void run_list(int b0, int b1, const Frame<S, K>& fr, int32_t* scratch,
                                         int* flag, const hb::FieldLane<K>& f, bool bit,
                                         bool inf, bool binf, int step) {
  const int at = kVersionStride * step;
#pragma unroll 1
  for (int k = b0; k < b1; ++k) {
    const hb_sched::Op op = kFp2 ? hb_sched::kG2Ops[k] : hb_sched::kG1Ops[k];
    wait_slot(flag, flag_of<S>(op.a, is_base(op, 0)), op.wait & 1, at + version(op, 0));
    wait_slot(flag, flag_of<S>(op.b, is_base(op, 1)), op.wait & 2, at + version(op, 1));
    wait_slot(flag, flag_of<S>(op.c, is_base(op, 2)), op.wait & 4, at + version(op, 2));
    __syncwarp();
    run_op<S, K>(op, fr, scratch, f, bit, inf, binf);
    __syncwarp();
    // a select's result is the next step's
    if (op.kind != hb_sched::SEL && hb::lane_id() == 0) {
      st_release(flag + flag_of<S>(op.dst, is_base(op, 3)), at + version(op, 3));
    }
  }
}

}  // namespace hb_ladder
