// Lazy BLS12-381 field multiply for Hopper (sm_90a): one warp per row.
//
// Replaces: hbbft_tpu/ops/pallas_fp.py :: fp_mul_lazy_pallas (body
// _mul_kernel → mul_lazy_cols), the same function that the JAX ladders run
// XLA-lowered as ops/fp381.py :: fp_mul_lazy.  Inputs and output are int32
// (NL=30, R) columns of 13-bit digits: limb i of row r at [i*R + r].
//
// What bounds it on this card: per row it moves 360 bytes (two 30-limb
// inputs, one 30-limb output) and does ~3.9k int32 instructions (900
// multiply-adds of the convolution, 930 of the fold, the carry passes), so
// it is bound by operations, and at the few hundred rows of a ladder by
// launch latency.
//
// Design: the multiply is fp_lazy.cuh's warp-cooperative product at one
// element a warp (K = 1: lane l holds digit l, the operands sit in shared
// memory, the carry passes run on shuffled windows), the one implementation
// of the lazy multiply in CUDA, which the ladder kernels run at K rows a
// warp; this kernel runs it on one row per warp and is held digit for
// digit against the plain version on its own.  Blocks of 4 warps (4 rows).

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_lazy.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
fp_mul_lazy_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b,
                   const int32_t* __restrict__ fold,
                   int32_t* __restrict__ out, int R) {
  __shared__ __align__(16) int32_t s_ab[kWarps][2][hb::kRowWords];
  __shared__ __align__(16) int32_t s_scratch[kWarps][hb::scratch_words<1>()];
  hb::FieldLane<1> f;
  hb::load_field<1>(f, fold, nullptr, nullptr);
  const int w = threadIdx.x >> 5;
  hb::zero_scratch<1>(s_scratch[w]);
  const int r = blockIdx.x * kWarps + w;
  if (r >= R) return;  // warp-uniform
  const int l = hb::lane_id();
  s_ab[w][0][l] = l < hb::NL ? a[l * R + r] : 0;
  s_ab[w][1][l] = l < hb::NL ? b[l * R + r] : 0;
  __syncwarp();
  int32_t o[1];
  hb::fp_mul_unsqueezed<1>(s_ab[w][0], s_ab[w][1], s_scratch[w], f, o);
  hb::squeeze<1>(o, f);
  if (l < hb::NL) out[l * R + r] = o[0];
}

}  // namespace

extern "C" int hb_fp_mul_lazy(const void* a, const void* b, const void* fold,
                              void* out, int R, void* stream) {
  const int blocks = (R + kWarps - 1) / kWarps;
  fp_mul_lazy_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)fold,
      (int32_t*)out, R);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
