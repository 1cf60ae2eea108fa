// Whole 4-bit windowed lazy scalar-mul ladder over the 8-bit-digit field,
// for Hopper (sm_90a): one launch runs every window of a batch of G1 or G2
// ladders, one block of several warps for K rows, the field's products on
// the tensor cores.
//
// Replaces: hbbft_tpu/ops/gcurve.py :: scalar_mul_lazy_window over
// MXU_FP_OPS / MXU_FP2_OPS (an XLA program on the TPU, no Pallas): the
// table [P, 2P, …, 15P], then per 4-bit window, most significant first, 4
// point_doubles and one point_add_raw of the entry the window selects,
// infinity as a flag; its field is hbbft_tpu/ops/fp381_mxu.py, whose
// fp_mul (:178) runs the digit convolution (:159 _conv_mxu) and the fold
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
// What bounds it on this card: the latency of a step's chains of
// dependent field operations (a product feeds a difference feeds a
// product), each a few hundred instructions of carries, shuffles and
// stages through shared memory around its 4 + 16 mma; at large batches the
// int32 instructions the schedulers issue.  The tensor-core work and the
// bytes are far below both.
//
// Design: the 13-bit ladder's (ladder_window.cu), over the 8-bit field of
// fp_mxu.cuh.  A block of 3 (G1) or 8 (G2) warps runs K rows, each warp
// every operation of its list for the K rows at once, from the static
// tables of ladder_schedule.h (the same tables: both fields expand Fp2 the
// same way, and every operation is a function of its operands' digits), a
// step's operations side by side on the warps, so a row's chain is a
// step's longest path and not its every operation; ladder_steps.cuh's
// window_body runs the phases: the table of entries by dbl and addp steps,
// then per window dblpro A→B, dbl B→A, dbl A→B and step B→A with the
// window's entry read in place, through one call site of the field's code.
// A product of the K rows shares one run of the fold on the tensor cores
// (the fold matrix as A, the K rows' high digits as B's columns), and the
// K rows' carries and squeezes run in one set of shuffles.  K by the
// number of rows (pick_k), as chip_smoke.py measured it on the H100.
//
// Constant time: every window runs the same steps whatever its value; the
// entry is a row offset, and no branch depends on the scalar.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_mxu.cuh"
#include "ladder_schedule.h"
#include "ladder_steps.cuh"

namespace {

using namespace hb_ladder;

template <int K>
using Fd = hb_mxu::Field<K>;

// K for a batch of R rows (pick_k), as chip_smoke.py's kernel_ladder_mxu
// sweep measured it on the H100 (PERF.md §6): 2 from rows_k2 rows (G1's
// 8-bit blocks of one row fill the SMs' shared memory from ~800 rows),
// else 1; K = 4 never (its blocks' shared memory leaves an SM too few
// warps: slower than K = 2 at every batch up to 8 192 rows), so it runs
// only through hb_ladder_mxu_k
template <bool kFp2>
__host__ __device__ constexpr int rows_k2() {
  return kFp2 ? 256 : 1024;
}
constexpr int kSms = 132;  // the H100 SXM's

// Blocks an SM for __launch_bounds__, which sets the registers a thread:
// at K = 2 and 4 as many as shared memory holds, at most 24 warps; at
// K = 1, whose batches are latency-bound, those of 512 G1 or 256 G2 rows,
// so a small batch's few blocks run on all the registers they can use (at
// G1's 7, as many as shared memory holds, the kernel took 75 registers, not
// 94, and ran 15 % slower)
template <class S, bool kFp2, int K>
constexpr int min_blocks() {
  constexpr int by_smem = Smem<Fd<K>, S>::kBlocksPerSm;
  constexpr int by_warps = 24 / S::kWarps;
  constexpr int cap = by_smem < by_warps ? by_smem : by_warps;
  constexpr int latency = ((kFp2 ? 256 : 512) + kSms - 1) / kSms;
  return K == 1 && latency < cap ? latency : cap;
}

template <class S, bool kFp2, int K>
__global__ void __launch_bounds__(S::kWarps * 32, min_blocks<S, kFp2, K>())
ladder_mxu_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                  const int32_t* __restrict__ pz, const int32_t* __restrict__ bits,
                  const uint8_t* __restrict__ base_inf, const int32_t* __restrict__ frag,
                  const int32_t* __restrict__ sq, const int32_t* __restrict__ subc,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  uint8_t* __restrict__ out_inf, int R, int nbits) {
  extern __shared__ __align__(16) int32_t smem[];
  window_body<Fd<K>, S, kFp2>(smem, px, py, pz, bits, base_inf, {frag, sq, subc}, ox, oy, oz,
                              out_inf, R, nbits);
}

template <class S, bool kFp2, int K>
int launch(const void* px, const void* py, const void* pz, const void* bits,
           const void* base_inf, const void* frag, const void* sq, const void* subc, void* ox,
           void* oy, void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  const auto kernel = &ladder_mxu_kernel<S, kFp2, K>;
  constexpr size_t bytes = Smem<Fd<K>, S>::kBytes;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(R + K - 1) / K, 32 * S::kWarps, bytes, stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)bits,
      (const uint8_t*)base_inf, (const int32_t*)frag, (const int32_t*)sq, (const int32_t*)subc,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (uint8_t*)out_inf, R, nbits);
  return (int)cudaGetLastError();
}

template <class S, bool kFp2>
int launch_k(int k, const void* px, const void* py, const void* pz, const void* bits,
             const void* base_inf, const void* frag, const void* sq, const void* subc, void* ox,
             void* oy, void* oz, void* out_inf, int R, int nbits, cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch<S, kFp2, 1>(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf,
                                R, nbits, stream);
    case 2:
      return launch<S, kFp2, 2>(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf,
                                R, nbits, stream);
    case 4:
      return launch<S, kFp2, 4>(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf,
                                R, nbits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int pick_k(int R, int fp2) {
  return R >= (fp2 ? rows_k2<true>() : rows_k2<false>()) ? 2 : 1;
}

template <class S, bool kFp2, int K>
int info(int* out) {
  const auto kernel = &ladder_mxu_kernel<S, kFp2, K>;
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
  out[5] = rows_k2<kFp2>();
  out[6] = 0;  // K = 4: never
  return (int)cudaSuccess;
}

}  // namespace

// One launch at K rows a block (K = 1, 2 or 4): every window of R ladders
// of nbits bits (a multiple of 4), G2 when fp2; returns the launch's
// cudaGetLastError().
extern "C" int hb_ladder_mxu_k(const void* px, const void* py, const void* pz, const void* bits,
                               const void* base_inf, const void* frag, const void* sq,
                               const void* subc, void* ox, void* oy, void* oz, void* out_inf,
                               int R, int nbits, int fp2, int k, void* stream) {
  if (nbits % kWindow != 0) return (int)cudaErrorInvalidValue;
  return fp2 ? launch_k<hb_sched::G2, true>(k, px, py, pz, bits, base_inf, frag, sq, subc, ox,
                                            oy, oz, out_inf, R, nbits, (cudaStream_t)stream)
             : launch_k<hb_sched::G1, false>(k, px, py, pz, bits, base_inf, frag, sq, subc, ox,
                                             oy, oz, out_inf, R, nbits, (cudaStream_t)stream);
}

// One launch at the K that pick_k chooses for R rows.
extern "C" int hb_ladder_mxu(const void* px, const void* py, const void* pz, const void* bits,
                             const void* base_inf, const void* frag, const void* sq,
                             const void* subc, void* ox, void* oy, void* oz, void* out_inf,
                             int R, int nbits, int fp2, void* stream) {
  return hb_ladder_mxu_k(px, py, pz, bits, base_inf, frag, sq, subc, ox, oy, oz, out_inf, R,
                         nbits, fp2, pick_k(R, fp2), stream);
}

extern "C" int hb_ladder_mxu_pick(int R, int fp2) { return pick_k(R, fp2); }

// The K-row kernel's registers, local (spilled) bytes, blocks an SM,
// dynamic shared memory bytes, warps a block, and pick_k's thresholds (K =
// 2 from out[5] rows, K = 4 from out[6], 0: never), into out[0 .. 7).
extern "C" int hb_ladder_mxu_info(int k, int fp2, int* out) {
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

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
