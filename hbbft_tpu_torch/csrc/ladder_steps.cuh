// The step machinery the ladder kernels share (ladder_lazy.cu, the bitwise
// ladder; ladder_window.cu and ladder_mxu.cu, the 4-bit windowed one over
// the 13-bit and the 8-bit field).
//
// Every template takes the field as a policy Fd (fp_lazy.cuh's
// hb::LazyField<K>, fp_mxu.cuh's hb_mxu::Field<K>): K field elements a
// warp, a row of Fd::kRowWords words an element, Fd::kDigits digits a lane,
// and the field's product, squeeze, sub constant and scratch.
//
// A block runs K rows (K in {1, 2, 4}) side by side: every warp computes
// each of its operations for the K rows at once, 32/K lanes a row, so the
// tables, flags, waits and barriers are paid once for K rows.  Every value
// of a step has a slot: a slot row in shared memory (K rows of the field's
// words) and a ready flag.  A table of the static schedule
// (ladder_schedule.h, generated by ops/ladder_schedule.py) gives each warp
// of the block an ordered list of lazy Fp operations; a warp waits for the
// flags of the operands other warps compute, computes, stores, and raises
// its destination's flag.  A step ends at a block barrier.  The tables
// hold kinds and slots only, so both fields run the same ones: every
// operation is a function of its operands' digits alone, in the order of
// the fields' own Fp2 formulas (the Karatsuba product and the square of
// ops/fp381.py and ops/fp381_mxu.py are the same expansion).
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

#include "ladder_schedule.h"

namespace hb_ladder {

constexpr int kVersionStride = 8;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

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

// N consecutive words (16-byte aligned for N ≥ 4, 8-byte for N = 2)
template <int N>
__device__ __forceinline__ void ldv(const int32_t* p, int32_t (&v)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "1, 2 or a multiple of 4 words");
  if constexpr (N == 1) {
    v[0] = *p;
  } else if constexpr (N == 2) {
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

template <int N>
__device__ __forceinline__ void stv(int32_t* p, const int32_t (&v)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "1, 2 or a multiple of 4 words");
  if constexpr (N == 1) {
    *p = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<int4*>(p)[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
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

// Words of a slot row: the K rows of one slot
template <class Fd>
__host__ __device__ constexpr int slot_words() {
  return Fd::kK * Fd::kRowWords;
}

// Where this lane's rows live: `rows` is slot row 0 of the block's
// accumulator sets and temporaries (slot s at rows + s·slot_words); a base
// row s is the base point's coordinate s of `base` (s < kAcc: a table
// entry, each of the K rows its own) or the prologue's value s − kAcc of
// `pro`; all offset to this lane's row (group) of the K.
template <class Fd, class S>
struct Frame {
  int32_t* rows;
  int32_t* base;
  int32_t* pro;

  __device__ __forceinline__ int32_t* row(int s, bool is_base) const {
    int32_t* const from = is_base ? (s < S::kAcc ? base : pro - S::kAcc * slot_words<Fd>()) : rows;
    return from + s * slot_words<Fd>();
  }
};

// Slot row `first` of a block region, at this lane's row
template <class Fd>
__device__ __forceinline__ int32_t* rows_at(int32_t* region, int first) {
  return region + first * slot_words<Fd>() + Fd::group() * Fd::kRowWords;
}

// An op's operand k (0, 1, 2: a, b, c; 3: dst) is a base row
__device__ __forceinline__ bool is_base(const hb_sched::Op& op, int k) {
  return (op.wait >> (4 + k)) & 1;
}

// One operation of the schedule on this warp; SEL writes the next
// accumulator: acc = bit ? (inf ? base : (binf ? d : s)) : d.
template <class Fd, class S>
__device__ __forceinline__ void run_op(hb_sched::Op op, const Frame<Fd, S>& fr, int32_t* scratch,
                                       const typename Fd::Lane& f, bool bit, bool inf,
                                       bool binf) {
  constexpr int D = Fd::kDigits;
  const int own = Fd::own();
  const int32_t* pa = fr.row(op.a, is_base(op, 0));
  const int32_t* pb = fr.row(op.b, is_base(op, 1));
  int32_t* pd = fr.row(op.dst, is_base(op, 3));
  int32_t x[D];
  if (op.kind == hb_sched::SEL) {
    int32_t base[D], d[D], s[D];
    ldv<D>(pa + own, base);
    ldv<D>(pb + own, d);
    ldv<D>(fr.row(op.c, is_base(op, 2)) + own, s);
#pragma unroll
    for (int m = 0; m < D; ++m) {
      const int32_t res = inf ? base[m] : (binf ? d[m] : s[m]);
      x[m] = bit ? res : d[m];
    }
    stv<D>(pd + own, x);
    return;
  }
  if (op.kind == hb_sched::MUL) {
    Fd::mul(pa, pb, scratch, f, x);
  } else {
    int32_t a[D], b[D];
    ldv<D>(pa + own, a);
    ldv<D>(pb + own, b);
    if (op.kind == hb_sched::ADD) {
#pragma unroll
      for (int m = 0; m < D; ++m) x[m] = a[m] + b[m];
    } else {  // a − b (mod p), lazy: a + (2·MASK − b) + sub constant
#pragma unroll
      for (int m = 0; m < D; ++m) x[m] = a[m] + f.subk[m] - b[m];
    }
  }
  Fd::squeeze(x, f);
  __syncwarp();  // every lane's reads of the operands are done
  stv<D>(pd + own, x);
}

// Coordinate slot k of a row from the (NL, W) digit columns (W = R for G1;
// W = 2R for G2, [re | im]) into its slot row (this lane's row r; zeros
// where r ≥ R and at the row's positions from NL), and back.
template <bool kFp2>
__device__ __forceinline__ int coord_col(int k, int R, int r) {
  return kFp2 ? ((k & 1) ? R + r : r) : r;
}

template <class Fd, bool kFp2>
__device__ __forceinline__ void load_coord(int32_t* row, const int32_t* __restrict__ p, int k,
                                           int R, int r) {
  constexpr int D = Fd::kDigits;
  const int W = kFp2 ? 2 * R : R, col = coord_col<kFp2>(k, R, r), p0 = Fd::first_digit();
  int32_t v[D];
#pragma unroll
  for (int m = 0; m < D; ++m) v[m] = (r < R && p0 + m < Fd::kNL) ? p[(p0 + m) * W + col] : 0;
  stv<D>(row + Fd::own(), v);
}

template <class Fd, bool kFp2>
__device__ __forceinline__ void store_coord(int32_t* __restrict__ p, const int32_t* row, int k,
                                            int R, int r) {
  constexpr int D = Fd::kDigits;
  const int W = kFp2 ? 2 * R : R, col = coord_col<kFp2>(k, R, r), p0 = Fd::first_digit();
  int32_t v[D];
  ldv<D>(row + Fd::own(), v);
#pragma unroll
  for (int m = 0; m < D; ++m) {
    if (r < R && p0 + m < Fd::kNL) p[(p0 + m) * W + col] = v[m];
  }
}

// The base point's coordinates into the first kAcc slot rows of `block`
// (row r of this lane; (x, y, z) × (re, im) order), a warp a slot
template <class Fd, class S, bool kFp2>
__device__ __forceinline__ void load_point(int32_t* block, int warp, const int32_t* px,
                                           const int32_t* py, const int32_t* pz, int R, int r) {
  const int32_t* coords[3] = {px, py, pz};
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    load_coord<Fd, kFp2>(rows_at<Fd>(block, k), coords[kFp2 ? k >> 1 : k], k, R, r);
  }
}

template <class Fd, class S, bool kFp2>
__device__ __forceinline__ void store_point(int32_t* block, int warp, int32_t* ox, int32_t* oy,
                                            int32_t* oz, int R, int r) {
  int32_t* outs[3] = {ox, oy, oz};
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    store_coord<Fd, kFp2>(outs[kFp2 ? k >> 1 : k], rows_at<Fd>(block, k), k, R, r);
  }
}

// the first n slot rows of `block` to zero, a warp a slot
template <class Fd, class S>
__device__ __forceinline__ void zero_rows(int32_t* block, int n, int warp) {
  for (int k = warp; k < n; k += S::kWarps) {
    for (int i = lane_id(); i < slot_words<Fd>(); i += 32) block[k * slot_words<Fd>() + i] = 0;
  }
}

// slot rows src[0 .. n) → dst[0 .. n), all K rows of each, a warp a slot
template <class Fd, class S>
__device__ __forceinline__ void copy_rows(int32_t* dst, const int32_t* src, int n, int warp) {
  for (int k = warp; k < n; k += S::kWarps) {
    for (int i = lane_id(); i < slot_words<Fd>(); i += 32) {
      dst[k * slot_words<Fd>() + i] = src[k * slot_words<Fd>() + i];
    }
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

// The flag of slot s, or of base row s (a prologue value: the coordinates
// are never waited for), after the slots' flags
template <class S>
__device__ __forceinline__ int flag_of(int s, bool is_base) {
  return is_base ? S::kSlots + s - S::kAcc : s;
}

// Operations [b0, b1) of the group's table array on this warp, as step
// number `step` (the caller ends the step with a block barrier); `scratch`
// is the warp's own.  Each kernel calls it from one place only, so the
// field's code is in the binary once: several inlined copies would not fit
// the instruction cache together.
template <class Fd, class S, bool kFp2>
__device__ __forceinline__ void run_list(int b0, int b1, const Frame<Fd, S>& fr, int32_t* scratch,
                                         int* flag, const typename Fd::Lane& f, bool bit,
                                         bool inf, bool binf, int step) {
  const int at = kVersionStride * step;
#pragma unroll 1
  for (int k = b0; k < b1; ++k) {
    const hb_sched::Op op = kFp2 ? hb_sched::kG2Ops[k] : hb_sched::kG1Ops[k];
    wait_slot(flag, flag_of<S>(op.a, is_base(op, 0)), op.wait & 1, at + version(op, 0));
    wait_slot(flag, flag_of<S>(op.b, is_base(op, 1)), op.wait & 2, at + version(op, 1));
    wait_slot(flag, flag_of<S>(op.c, is_base(op, 2)), op.wait & 4, at + version(op, 2));
    __syncwarp();
    run_op<Fd, S>(op, fr, scratch, f, bit, inf, binf);
    __syncwarp();
    // a select's result is the next step's
    if (op.kind != hb_sched::SEL && lane_id() == 0) {
      st_release(flag + flag_of<S>(op.dst, is_base(op, 3)), at + version(op, 3));
    }
  }
}

// ---------------------------------------------------------------------
// The 4-bit windowed ladder (ladder_window.cu over the 13-bit field,
// ladder_mxu.cu over the 8-bit one): the body of their kernels.

constexpr int kWindow = 4;
constexpr int kEntries = (1 << kWindow) - 1;  // P … 15P
constexpr int kSmemPerSm = 233472;            // 228 KB, of which 1 KB a block is the system's
constexpr int kSmemPerBlockReserved = 1024;

// Shared memory of a block, words of each region, in this order
template <class Fd, class S>
struct Smem {
  static constexpr int kSlotRow = slot_words<Fd>();
  static constexpr int kRows = S::kSlots * kSlotRow;  // A, B, the temporaries
  static constexpr int kTable = kEntries * S::kAcc * kSlotRow;  // coordinates only
  static constexpr int kPro = (S::kEntry - S::kAcc) * kSlotRow;  // the base block's prologue values
  static constexpr int kScratch = S::kWarps * Fd::kScratchWords;
  static constexpr int kConst = Fd::kConstWords;
  static constexpr int kWords = kRows + kTable + kPro + kScratch + kConst + S::kFlags;
  static constexpr size_t kBytes = sizeof(int32_t) * kWords;
  static constexpr int kBlocksPerSm = kSmemPerSm / (kBytes + kSmemPerBlockReserved);
};

// A block of S::kWarps warps runs K = Fd::kK rows of a batch of R ladders
// of nbits bits (see ladder_window.cu's head comment), `smem` its dynamic
// shared memory of Smem<Fd, S>::kBytes.
template <class Fd, class S, bool kFp2>
__device__ __forceinline__ void window_body(int32_t* smem, const int32_t* __restrict__ px,
                                            const int32_t* __restrict__ py,
                                            const int32_t* __restrict__ pz,
                                            const int32_t* __restrict__ bits,
                                            const uint8_t* __restrict__ base_inf,
                                            const typename Fd::Consts& consts,
                                            int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                            int32_t* __restrict__ oz,
                                            uint8_t* __restrict__ out_inf, int R, int nbits) {
  using M = Smem<Fd, S>;
  constexpr int K = Fd::kK;
  int32_t* rows = smem;  // A: slots 0 .. kAcc − 1, B: kAcc .. 2 kAcc − 1, the temporaries
  int32_t* acc_b = rows + S::kAcc * M::kSlotRow;
  int32_t* table = rows + M::kRows;
  int32_t* pro = table + M::kTable;
  int32_t* scratch = pro + M::kPro;
  int32_t* const_s = scratch + M::kScratch;
  int* flag = reinterpret_cast<int*>(const_s + M::kConst);

  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * K + Fd::group();  // this lane's row
  const bool valid = r < R;
  int32_t* wscratch = scratch + warp * Fd::kScratchWords;
  for (int i = threadIdx.x; i < S::kFlags; i += blockDim.x) flag[i] = 0;
  Fd::stage(const_s, wscratch, consts);
  load_point<Fd, S, kFp2>(table, warp, px, py, pz, R, r);
  __syncthreads();
  typename Fd::Lane f;
  Fd::load(f, consts, const_s);

  // entry e's coordinates: the whole block's, and this lane's
  auto entry_block = [&](int e) { return table + e * S::kAcc * M::kSlotRow; };
  auto entry = [&](int e) { return rows_at<Fd>(table, e * S::kAcc); };
  int32_t* const my_rows = rows_at<Fd>(rows, 0);
  int32_t* const my_pro = rows_at<Fd>(pro, 0);
  const bool binf = valid ? base_inf[r] != 0 : true;
  const int32_t* rbits = bits + static_cast<size_t>(valid ? r : 0) * nbits;

  // The phases, one step each, through one call of run_list: the prologue
  // of P (warp 0); the table, entry k − 1 (k = 2 .. 15) from entry src by
  // an addp step (k odd: (k − 1)·P + P) or a dbl step (2·(k/2)·P), src
  // copied into A and the result (in B) into entry k − 1 at the next phase;
  // then per window (MSB first) dbl A→B with the prologue of entry idx − 1
  // beside it, dbl B→A, dbl A→B, and the bitwise ladder's step B→A with
  // base T[idx] and bit idx ≠ 0: the fourth doubling, the addition of
  // entry idx and the selects.
  constexpr int kWindows0 = kEntries;
  const int phases = kWindows0 + (nbits / kWindow) * kWindow;
  bool inf = true;
  int idx = 0;
#pragma unroll 1
  for (int ph = 0; ph < phases; ++ph) {
    int table_id = hb_sched::kPrologue;
    bool run = true, used = false;
    int32_t* base = entry(0);
    if (ph == 0) {
      run = warp == 0;
    } else if (ph < kWindows0) {
      const int k = ph + 1;
      const int src = (k & 1) ? k - 2 : k / 2 - 1;
      if (k > 2) copy_rows<Fd, S>(entry_block(k - 2), acc_b, S::kAcc, warp);
      // the entry the last phase made is still in B
      copy_rows<Fd, S>(rows, k > 2 && src == k - 2 ? acc_b : entry_block(src), S::kAcc, warp);
      __syncthreads();
      table_id = (k & 1) ? hb_sched::kAddpAB : hb_sched::kDblAB;
    } else {
      const int w = (ph - kWindows0) / kWindow, d = (ph - kWindows0) % kWindow;
      if (d == 0) {
        if (w == 0) {
          copy_rows<Fd, S>(entry_block(kEntries - 1), acc_b, S::kAcc, warp);
          zero_rows<Fd, S>(rows, S::kAcc, warp);  // A: acc = ∞
          __syncthreads();
        }
        const int i = nbits - kWindow * (w + 1);
        idx = valid ? ((rbits[i] != 0) | (rbits[i + 1] != 0) << 1 | (rbits[i + 2] != 0) << 2 |
                       (rbits[i + 3] != 0) << 3)
                    : 0;
      }
      used = idx != 0;
      table_id = d == 0 ? hb_sched::kDblproAB
                        : (d == 1 ? hb_sched::kDblBA
                                  : (d == 2 ? hb_sched::kDblAB : hb_sched::kStepBA));
      base = entry(used ? idx - 1 : 0);
    }
    const int b0 = list_bound<kFp2>(table_id, warp, 0);
    const int b1 = run ? list_bound<kFp2>(table_id, warp, 1) : b0;
    run_list<Fd, S, kFp2>(b0, b1, {my_rows, base, my_pro}, wscratch, flag, f, used, inf, binf,
                          ph + 1);
    if (table_id == hb_sched::kStepBA) inf = used ? (inf && binf) : inf;
    __syncthreads();
  }

  store_point<Fd, S, kFp2>(rows, warp, ox, oy, oz, R, r);
  if (warp == 0 && Fd::first_digit() == 0 && valid) out_inf[r] = inf ? 1 : 0;
}

}  // namespace hb_ladder
