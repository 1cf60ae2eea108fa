// Whole 4-bit windowed lazy scalar-mul ladder for Hopper (sm_90a): one
// launch runs every step of a batch of G1 or G2 ladders, one block of
// several warps for K rows.
//
// Replaces: hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy_window (an XLA
// program on the TPU: the table [P, 2P, …, 15P], then a jax.lax.fori_loop
// over the windows, MSB first — 4 point_doubles, point_add_raw of the entry
// the window selects through a one-hot contraction, the selects and the
// infinity flag).  Digit-exact and inf-exact with the port's plain version
// (ops/gcurve.py :: scalar_mul_lazy_window_plain).
//
// Inputs and outputs as in ladder_lazy.cu; nbits is a multiple of 4.
//
// What bounds it on this card: int32 operations (a G1 row does ~10^7 of
// them on a few KB of state), issued by warps that wait on each other's
// operands; at small batches the latency of a step's chain of operations.
// The design spends fewer instructions on an element the more elements a
// warp holds, shares every wait, barrier and table read among K rows, and
// keeps the field's code in the binary once.
//
// Design.  A block of 3 (G1) or 8 (G2) warps runs K rows, each warp every
// operation for the K rows at once (ladder_steps.cuh's window_body,
// which ladder_mxu.cu runs over the 8-bit field; here the field of
// fp_lazy.cuh); K = 4 from 512 rows, else 2 (G2 from 256 rows) or 1
// (pick_k, as the card measured it).  The tables of the static schedule:
// dbl (a doubling of the accumulator), dblpro (dbl and, beside it, the
// prologue of the step's base block: Z2², the Karatsuba sums), addp (the
// accumulator plus the base point) and step (the bitwise kernel's: double,
// add the base, select).  Each step reads one accumulator set and writes
// the other, so a window
//     acc ← 2·2·2·2·acc (+ T[idx] where idx ≠ 0)
// is dblpro A→B, dbl B→A, dbl A→B, and step B→A whose base is entry
// idx − 1 of the row's own table, read in place: four steps, four
// barriers, no copies.  A table entry holds the coordinates only (G2 rows
// would not fit otherwise); the prologue's values of the window's entry go
// to a block area of their own.  The table is built before the windows:
// entry k − 1 (k = 2 .. 15) by a dbl step from entry k/2 − 1 or an addp
// step from entry k − 2, with P and its prologue the base, the source
// copied into A and the result from B.  Every step runs through one call
// site of run_list (a loop over the phases), so the field's code is in the
// binary once.  Shared memory: the two accumulator sets and the
// temporaries (reused within a step, ladder_schedule.py), the 15 entries,
// the prologue's values, the warps' fold scratch, the residue rows (K > 1)
// and the flags.
//
// Constant time: every window runs the same steps whatever its value; the
// entry is a row offset, and every lane reads its own chunk's banks
// whatever the index, so neither a branch nor a bank conflict depends on
// the scalar.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_lazy.cuh"
#include "ladder_schedule.h"
#include "ladder_steps.cuh"

namespace {

using namespace hb_ladder;

template <int K>
using Fd = hb::LazyField<K>;

// K for a batch of R rows (pick_k), as chip_smoke.py's ladder_crossover
// measured it on the H100 (PERF.md §6): 4 from kRowsK4 rows (below, its
// R/4 blocks leave SMs idle); under it 2 from rows_k2 (G2, whose blocks of
// 8 warps share an SM badly), else 1
constexpr int kRowsK4 = 512;
template <bool kFp2>
__host__ __device__ constexpr int rows_k2() {
  return kFp2 ? 256 : kRowsK4;
}
constexpr int kSms = 132;  // the H100 SXM's

// Blocks an SM for __launch_bounds__, which sets the registers a thread: at
// K = 4 as many as shared memory holds, at most 24 warps; at K = 1 and 2
// the most that pick_k's row range for that K puts on one SM, so a small
// batch's few blocks run on all the registers they can use
template <class S, bool kFp2, int K>
constexpr int min_blocks() {
  if (K == 4) {
    constexpr int by_smem = Smem<Fd<K>, S>::kBlocksPerSm;
    constexpr int by_warps = 24 / S::kWarps;
    return by_smem < by_warps ? by_smem : by_warps;
  }
  constexpr int rows = K == 2 ? kRowsK4 : rows_k2<kFp2>();
  return (rows / K + kSms - 1) / kSms;
}

template <class S, bool kFp2, int K>
__global__ void __launch_bounds__(S::kWarps * 32, min_blocks<S, kFp2, K>())
ladder_window_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                     const uint8_t* __restrict__ base_inf,
                     const int32_t* __restrict__ fold, const int32_t* __restrict__ subc,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz, uint8_t* __restrict__ out_inf,
                     int R, int nbits) {
  extern __shared__ __align__(16) int32_t smem[];
  window_body<Fd<K>, S, kFp2>(smem, px, py, pz, bits, base_inf, {fold, subc}, ox, oy, oz,
                              out_inf, R, nbits);
}

template <class S, bool kFp2, int K>
int launch(const void* px, const void* py, const void* pz, const void* bits,
           const void* base_inf, const void* fold, const void* subc, void* ox, void* oy,
           void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  const auto kernel = &ladder_window_kernel<S, kFp2, K>;
  constexpr size_t bytes = Smem<Fd<K>, S>::kBytes;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(R + K - 1) / K, 32 * S::kWarps, bytes, stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)bits,
      (const uint8_t*)base_inf, (const int32_t*)fold, (const int32_t*)subc, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

template <class S, bool kFp2>
int launch_k(int k, const void* px, const void* py, const void* pz, const void* bits,
             const void* base_inf, const void* fold, const void* subc, void* ox, void* oy,
             void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch<S, kFp2, 1>(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz, out_inf, R,
                                nbits, stream);
    case 2:
      return launch<S, kFp2, 2>(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz, out_inf, R,
                                nbits, stream);
    case 4:
      return launch<S, kFp2, 4>(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz, out_inf, R,
                                nbits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The field at K elements a warp, on its own: rows r of a, b (R rows of 32
// digits, digits 30 and 31 zero) → row r of out, one warp a block for K
// rows.  kKind: MUL, ADD, SUB, or −1 for none (the row copied: the probes'
// common cost).  `reps` > 1 chains the operation: a ← a op b, `reps`
// times, each reading the last one's result (a warp's latency of one
// operation: a launch of one block over reps).  No path launches it:
// chip_smoke.py holds it digit-exact against the plain field, times the
// chain and counts its SASS instructions, an operation's less the empty
// probe's.
template <int K, int kKind>
__global__ void __launch_bounds__(32)
lazy_op_probe(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, const int32_t* __restrict__ fold,
              const int32_t* __restrict__ subc, int R, int reps) {
  using L = hb::Lanes<K>;
  __shared__ __align__(16) int32_t rows[2][K * hb::kRowWords];
  __shared__ __align__(16) int32_t scratch[K * hb::scratch_words<K>()];
  __shared__ __align__(16) int32_t fold_s[K > 1 ? hb::kFoldRows * hb::kRowWords : 4];
  if constexpr (K > 1) hb::stage_fold(fold_s, fold);
  const int g = L::group(), j = L::chunk();
  const int r = blockIdx.x * K + g;
  hb::zero_scratch<K>(scratch + g * hb::scratch_words<K>());
  const int own = L::at(j, g);
  int32_t v[K];
  const int32_t* src[2] = {a, b};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    for (int m = 0; m < K; ++m) v[m] = r < R ? src[t][r * hb::kRowWords + K * j + m] : 0;
    hb::st<K>(rows[t] + g * hb::kRowWords + own, v);
  }
  __syncthreads();
  hb::FieldLane<K> f;
  hb::load_field<K>(f, fold, subc, fold_s);
  int32_t* ra = rows[0] + g * hb::kRowWords;
  int32_t x[K], y[K];
  hb::ld<K>(ra + own, x);
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (kKind == hb_sched::MUL) {
      hb::fp_mul_unsqueezed<K>(ra, rows[1] + g * hb::kRowWords, scratch + g * hb::scratch_words<K>(),
                               f, x);
      hb::squeeze<K>(x, f);
    } else if constexpr (kKind == hb_sched::ADD || kKind == hb_sched::SUB) {
      hb::ld<K>(rows[1] + g * hb::kRowWords + own, y);
#pragma unroll
      for (int m = 0; m < K; ++m) x[m] += kKind == hb_sched::ADD ? y[m] : f.subk[m] - y[m];
      hb::squeeze<K>(x, f);
    } else {  // the field's constants live all the same, at no instruction's cost
#pragma unroll
      for (int m = 0; m < K; ++m) {
        asm volatile("" ::"r"(f.row0[m]), "r"(f.subk[m]), "r"(f.keep[m]));
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) asm volatile("" ::"r"(f.below[d]), "r"(f.row0w[d]));
      if constexpr (K == 1) {
#pragma unroll
        for (int i = 0; i < hb::kFoldRows; ++i) asm volatile("" ::"r"(f.fold[i]));
      }
    }
    __syncwarp();
    hb::st<K>(ra + own, x);
    __syncwarp();
  }
  if (r < R) {
    for (int m = 0; m < K; ++m) out[r * hb::kRowWords + K * j + m] = x[m];
  }
}

template <int K>
int probe_k(int kind, const void* a, const void* b, void* out, const void* fold,
            const void* subc, int R, int reps, cudaStream_t stream) {
  void (*kernel)(const int32_t*, const int32_t*, int32_t*, const int32_t*, const int32_t*, int,
                 int);
  switch (kind) {
    case hb_sched::MUL: kernel = &lazy_op_probe<K, hb_sched::MUL>; break;
    case hb_sched::ADD: kernel = &lazy_op_probe<K, hb_sched::ADD>; break;
    case hb_sched::SUB: kernel = &lazy_op_probe<K, hb_sched::SUB>; break;
    case -1: kernel = &lazy_op_probe<K, -1>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<(R + K - 1) / K, 32, 0, stream>>>((const int32_t*)a, (const int32_t*)b,
                                            (int32_t*)out, (const int32_t*)fold,
                                            (const int32_t*)subc, R, reps);
  return (int)cudaGetLastError();
}

int pick_k(int R, int fp2) {
  if (R >= kRowsK4) return 4;
  return R >= (fp2 ? rows_k2<true>() : rows_k2<false>()) ? 2 : 1;
}

template <class S, bool kFp2, int K>
int info(int* out) {
  const auto kernel = &ladder_window_kernel<S, kFp2, K>;
  constexpr size_t bytes = Smem<Fd<K>, S>::kBytes;
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * S::kWarps, bytes);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)bytes;
  out[4] = S::kWarps;
  return 0;
}

}  // namespace

// One launch at K rows a block (K = 1, 2 or 4).
extern "C" int hb_ladder_window_k(const void* px, const void* py, const void* pz,
                                  const void* bits, const void* base_inf,
                                  const void* fold, const void* subc,
                                  void* ox, void* oy, void* oz, void* out_inf,
                                  int R, int nbits, int fp2, int k, void* stream) {
  if (nbits % kWindow != 0) return (int)cudaErrorInvalidValue;
  return fp2 ? launch_k<hb_sched::G2, true>(k, px, py, pz, bits, base_inf, fold, subc, ox, oy,
                                            oz, out_inf, R, nbits, (cudaStream_t)stream)
             : launch_k<hb_sched::G1, false>(k, px, py, pz, bits, base_inf, fold, subc, ox, oy,
                                             oz, out_inf, R, nbits, (cudaStream_t)stream);
}

// One launch at the K that pick_k chooses for R rows.
extern "C" int hb_ladder_window(const void* px, const void* py, const void* pz,
                                const void* bits, const void* base_inf,
                                const void* fold, const void* subc,
                                void* ox, void* oy, void* oz, void* out_inf,
                                int R, int nbits, int fp2, void* stream) {
  return hb_ladder_window_k(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz, out_inf, R,
                            nbits, fp2, pick_k(R, fp2), stream);
}

extern "C" int hb_ladder_window_pick(int R, int fp2) { return pick_k(R, fp2); }

// The K-row kernel's registers, local (spilled) bytes, blocks an SM,
// dynamic shared memory bytes and warps a block, into out[0 .. 5).
extern "C" int hb_ladder_window_info(int k, int fp2, int* out) {
  switch (k * 2 + (fp2 ? 1 : 0)) {
    case 2: return info<hb_sched::G1, false, 1>(out);
    case 3: return info<hb_sched::G2, true, 1>(out);
    case 4: return info<hb_sched::G1, false, 2>(out);
    case 5: return info<hb_sched::G2, true, 2>(out);
    case 8: return info<hb_sched::G1, false, 4>(out);
    case 9: return info<hb_sched::G2, true, 4>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of the field probe at K elements a warp (kind: 0 MUL, 1 ADD,
// 2 SUB, −1 none), the operation chained `reps` times.
extern "C" int hb_lazy_op_probe(int k, int kind, const void* a, const void* b, void* out,
                                const void* fold, const void* subc, int R, int reps,
                                void* stream) {
  switch (k) {
    case 1: return probe_k<1>(kind, a, b, out, fold, subc, R, reps, (cudaStream_t)stream);
    case 2: return probe_k<2>(kind, a, b, out, fold, subc, R, reps, (cudaStream_t)stream);
    case 4: return probe_k<4>(kind, a, b, out, fold, subc, R, reps, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
