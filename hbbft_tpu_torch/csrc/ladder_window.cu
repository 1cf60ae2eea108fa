// Whole 4-bit windowed lazy scalar-mul ladder for Hopper (sm_90a): one
// launch runs every step of a batch of G1 or G2 ladders, one block of
// several warps per row.
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
// Design.  The same block of 3 (G1) or 8 (G2) warps a row, the same slots,
// flags and tables as the bitwise kernel (ladder_steps.cuh), and two more
// tables over the same slot layout: dbl (a doubling of the accumulator)
// and addp (the accumulator plus the base point); their results stay in
// temporaries and are copied after a barrier.  A window
//     acc ← 2·2·2·2·acc (+ T[idx] where idx ≠ 0)
// is three dbl steps and then one step of the bitwise ladder whose base is
// T[idx] and whose bit is idx ≠ 0: that step doubles, adds the base and
// selects exactly as the reference's window body does.  So a table entry
// holds what the bitwise kernel's base block holds, the coordinates and
// the prologue's values (Z2², the Karatsuba sums), and before the step the
// block copies entry idx into the base block.  The table is built in the
// same slots before the windows: entry 2k by a dbl step from entry k,
// entry 2k + 1 by an addp step from entry 2k, each entry's prologue on one
// warp, the warps side by side.  The table lives in dynamic shared memory
// after the slots: 15 entries × 4 (G1) or 14 (G2) rows of 32 digits.
//
// Constant time: every window runs the same steps whatever its value, and
// the entry's copy reads one row per lane's own bank whatever the index, so
// neither a branch nor a bank conflict depends on the scalar.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_lazy.cuh"
#include "ladder_schedule.h"
#include "ladder_steps.cuh"

namespace {

using hb::NL;
using namespace hb_ladder;

constexpr int kWindow = 4;
constexpr int kEntries = (1 << kWindow) - 1;  // P … 15P
constexpr int kScratch = 192;                 // fp_mul_unsqueezed's, per warp

template <class S>
__host__ __device__ constexpr int entry_rows() {
  return S::kFirstTemp - S::kAcc;  // the base block: coordinates, prologue values
}

template <class S>
constexpr size_t smem_bytes() {
  return sizeof(int32_t) *
         (32 * (S::kWinSlots + kEntries * entry_rows<S>()) + S::kWarps * kScratch +
          S::kWinSlots);
}

// rows src[0 .. n) → dst[0 .. n), a warp a row
template <class S>
__device__ __forceinline__ void copy_rows(int32_t (*dst)[32], const int32_t (*src)[32], int n,
                                          int warp) {
  for (int k = warp; k < n; k += S::kWarps) dst[k][hb::lane_id()] = src[k][hb::lane_id()];
}

// the results of table T (temporaries) → dst[0 .. kAcc)
template <class S, bool kFp2, Table T>
__device__ __forceinline__ void copy_out(int32_t (*dst)[32], const int32_t (*sv)[32], int warp) {
  for (int k = warp; k < S::kAcc; k += S::kWarps) {
    dst[k][hb::lane_id()] = sv[table_out<kFp2, T>(k)][hb::lane_id()];
  }
}

// Blocks an SM, as many as the bitwise kernel gets: registers bound both
// (65 536 an SM).  G2, 8 warps: 3 blocks, at most 85 registers a thread
// (unbounded, ptxas takes 95 and 2 blocks fit); G1, 3 warps: 8 blocks
// (with a minimum of 1, ptxas takes 141 registers and 4 blocks fit)
template <class S, bool kFp2>
__global__ void __launch_bounds__(S::kWarps * 32, kFp2 ? 3 : 8)
ladder_window_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                     const uint8_t* __restrict__ base_inf,
                     const int32_t* __restrict__ fold, const int32_t* __restrict__ subc,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz, uint8_t* __restrict__ out_inf,
                     int R, int nbits) {
  constexpr int kEntry = entry_rows<S>();
  extern __shared__ __align__(16) int32_t smem[];
  int32_t(*sv)[32] = reinterpret_cast<int32_t(*)[32]>(smem);  // kWinSlots rows
  int32_t(*table)[32] = sv + S::kWinSlots;                     // kEntries × kEntry rows
  int32_t* scratch = smem + 32 * (S::kWinSlots + kEntries * kEntry);
  int* flag = reinterpret_cast<int*>(scratch + S::kWarps * kScratch);

  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x;  // one row per block
  int32_t* wscratch = scratch + warp * kScratch;
  hb::FieldLane f;
  hb::load_field(f, fold, subc);
  hb::zero_scratch(wscratch);

  for (int i = threadIdx.x; i < S::kWinSlots; i += blockDim.x) flag[i] = 0;
  load_row<S, kFp2>(sv, warp, px, py, pz, R, r);
  __syncthreads();
  if (warp == 0) run_prologue<kFp2, S::kPrologue>(sv, wscratch, f);
  __syncthreads();

  // the table: entry e holds (e + 1)·P; entry 0 is the base block
  int step = 0;
  copy_rows<S>(table, sv + S::kAcc, kEntry, warp);
#pragma unroll 1
  for (int k = 2; k <= kEntries; ++k) {
    __syncthreads();
    const int src = (k & 1) ? k - 2 : k / 2 - 1;  // (k − 1)·P + P, or 2·(k/2)·P
    copy_rows<S>(sv, table + src * kEntry, S::kAcc, warp);
    __syncthreads();
    ++step;
    int32_t(*dst)[32] = table + (k - 1) * kEntry;
    if (k & 1) {
      run_table<kFp2, kAddp>(warp, sv, wscratch, flag, f, false, false, false, step);
      __syncthreads();
      copy_out<S, kFp2, kAddp>(dst, sv, warp);
    } else {
      run_table<kFp2, kDbl>(warp, sv, wscratch, flag, f, false, false, false, step);
      __syncthreads();
      copy_out<S, kFp2, kDbl>(dst, sv, warp);
    }
  }
  __syncthreads();
  // every other entry's prologue, on the entry's own rows (slot s of the
  // block is row s − kAcc of the entry)
  for (int e = 1 + warp; e < kEntries; e += S::kWarps) {
    run_prologue<kFp2, S::kPrologue>(table + e * kEntry - S::kAcc, wscratch, f);
  }
  for (int k = warp; k < S::kAcc; k += S::kWarps) sv[k][hb::lane_id()] = 0;  // acc = ∞
  __syncthreads();

  const bool binf = base_inf[r] != 0;
  const int32_t* rbits = bits + static_cast<size_t>(r) * nbits;
  bool inf = true;
#pragma unroll 1
  for (int i = nbits - kWindow; i >= 0; i -= kWindow) {  // MSB window first
    const int idx = (rbits[i] != 0) | (rbits[i + 1] != 0) << 1 | (rbits[i + 2] != 0) << 2 |
                    (rbits[i + 3] != 0) << 3;
#pragma unroll 1
    for (int d = 1; d < kWindow; ++d) {
      ++step;
      run_table<kFp2, kDbl>(warp, sv, wscratch, flag, f, false, false, false, step);
      __syncthreads();
      copy_out<S, kFp2, kDbl>(sv, sv, warp);
      __syncthreads();
    }
    // the fourth doubling, the addition of entry idx and the selects: the
    // bitwise ladder's step with base T[idx] and bit idx ≠ 0
    copy_rows<S>(sv + S::kAcc, table + (idx ? idx - 1 : 0) * kEntry, kEntry, warp);
    __syncthreads();
    ++step;
    const bool used = idx != 0;
    run_table<kFp2, kStep>(warp, sv, wscratch, flag, f, used, inf, binf, step);
    inf = used ? (inf && binf) : inf;
    __syncthreads();
  }

  store_row<S, kFp2>(sv, warp, ox, oy, oz, R, r);
  if (threadIdx.x == 0) out_inf[r] = inf ? 1 : 0;
}

template <class S, bool kFp2>
int launch(const void* px, const void* py, const void* pz, const void* bits,
           const void* base_inf, const void* fold, const void* subc, void* ox, void* oy,
           void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  const auto kernel = &ladder_window_kernel<S, kFp2>;
  constexpr size_t bytes = smem_bytes<S>();
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<R, 32 * S::kWarps, bytes, stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)bits,
      (const uint8_t*)base_inf, (const int32_t*)fold, (const int32_t*)subc, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hb_ladder_window(const void* px, const void* py, const void* pz,
                                const void* bits, const void* base_inf,
                                const void* fold, const void* subc,
                                void* ox, void* oy, void* oz, void* out_inf,
                                int R, int nbits, int fp2, void* stream) {
  if (nbits % kWindow != 0) return (int)cudaErrorInvalidValue;
  return fp2 ? launch<hb_sched::G2, true>(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz,
                                          out_inf, R, nbits, (cudaStream_t)stream)
             : launch<hb_sched::G1, false>(px, py, pz, bits, base_inf, fold, subc, ox, oy, oz,
                                           out_inf, R, nbits, (cudaStream_t)stream);
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
