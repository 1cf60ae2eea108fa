// The GF(2) bit-plane product over packed bits, for Hopper (sm_90a):
//     out[b, t, c] = parity(popc(a[b, t, :] & m[b, c, :]))
// with both operands packed 32 bits a word along the contraction axis
// (word w holds bits 32w … 32w+31, LSB first) and the output packed too,
// 8 columns a byte (column c is bit c % 8 of byte c / 8 of its row).
//
// Replaces: hbbft_tpu/ops/gf256.py :: gf_apply_bitmatrix (:301) and
// hbbft_tpu/ops/gf16.py's product (:221), the int8 x int8 -> int32 MXU
// matmul with the parity taken afterwards; XLA, not Pallas.  A constant
// GF(2^8) or GF(2^16) matrix applied to shard symbols is this product: the
// RBC's encode and re-encode, its survivor decode (one matrix per batch
// entry: m_batch_stride != 0) and the host coder's ``device`` backend.
//
// What bounds it on this card: the tensor cores' 1-bit product (wgmma
// m64nNk256 .b1 .and.popc: popc(a & b) summed, whose low bit is the
// parity) ran 7.9e15 bit-products a second on an H100 80GB HBM3 at 700 W,
// fifteen times the ALU pipe's LOP3 (64 lanes a clock per SM: 5.35e14),
// so the paths' shapes are bound by their bytes (the packed matrix streamed
// once: 1.91 GB at N = 16384; the data rows and the output at N = 64),
// except the N = 1024 chunk, whose operands sit in L2 (chip_smoke.py's
// kernel_bitplane measures the rates with hb_bitplane_probe).
//
// Design: one warpgroup a block computes 64 data rows (one batch entry's)
// against 128 columns with one wgmma m64n128k256 a k256 step, both operands
// read by the tensor cores from shared memory.  The packed layouts are the
// operands' own: data rows [row][word] are A K-major and the matrix
// [column][word] B K-major, a k256 step being PACK_WORDS = 8 words (32
// bytes).  TMA copies boxes of up to 4 steps (128 bytes) a row into a ring
// of stages with the matching swizzle (32, 64 or 128 bytes), each stage
// signalled by an mbarrier; thread 0 refills a stage as soon as the wgmma
// that read it has completed, so the copies of the next stages run under
// this one's products.  Two routes, by the contraction's length:
//  - resident (at most 4 steps and 512 columns: the GF(2^8) coders): the
//    matrix (all its columns) is copied once and stays; the ring streams
//    64-row tiles, each multiplied against 128-column chunks of it in
//    turn, and a block walks a range of its entry's row tiles, the ranges
//    sized so that the grid is one wave over the card;
//  - streamed (the GF(2^16) chunks): a block is one row tile x 128
//    columns, and each stage holds 4 steps of both operands, so the matrix
//    is read from HBM once a row tile.
// Rows and columns past the operands read as the zeros TMA fills in, or as
// a neighbouring entry's, and their outputs are not written.  Epilogue:
// each s32 accumulator's low bit; two shuffles in the quad gather a row's
// 32 column bits into a word; the words go through shared memory and out
// as whole rows of the block's columns.  Padding words are the zeros the
// packers write.

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;           // data rows a tile: one wgmma's M
constexpr int kCols = 128;          // columns a wgmma: its N
constexpr int kThreads = 128;       // one warpgroup
constexpr int kStep = 32;           // bytes of one k256 step of a row or a column
constexpr int kMaxBox = 4;          // k256 steps a TMA box: 128 bytes, the widest swizzle
constexpr int kResidentCols = 512;  // the resident route's widest matrix
constexpr int kResidentRing = 8;    // row tiles in flight, resident route
constexpr int kStreamRing = 4;      // stages in flight, streamed route
constexpr int kAlign = 1024;        // a swizzle pattern's period

struct Params {
  int rows, words, cols;
  int row_tiles;   // 64-row tiles of one batch entry
  int chunks;      // blocks a batch entry's row tiles are split over
  int per_batch;   // 1: a matrix a batch entry
  int box_steps;   // k256 steps a box (1, 2 or 4): the swizzle is 32 x box_steps bytes
  int stages;      // stages a row tile (1 on the resident route)
  int col_chunks;  // 128-column chunks a block
  uint8_t* out;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity ``phase`` to complete; a copy that never
// lands (seconds of waiting) traps rather than hangs the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
    if (spins == (1u << 22)) __trap();
  }
}

// one box of ``map`` at (byte x, row y) into ``dst``, counted on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// K-major operand in shared memory, rows of ``sw`` bytes swizzled by TMA
// (sw = 32, 64 or 128), 8-row atoms 8 * sw bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int sw) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * sw) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = popc(A & B) + (accumulate ? d : 0) over one k256 step: A 64 rows,
// B 128 columns
__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The low bits of eight accumulators, two a byte: x0, x1 to bits 2t and
// 2t + 1 of byte 0, x2, x3 of byte 1, and so on; the other bits 0.  Each
// pair is packed by one XOR ((x0 & 1) ^ (x1 << 1) is right in its low two
// bits), the four pairs' low bytes by three byte permutes, and one mask.
__device__ __forceinline__ uint32_t lane_word(int x0, int x1, int x2, int x3, int x4, int x5,
                                              int x6, int x7, int t) {
  const uint32_t p0 = ((uint32_t)x0 & 1u) ^ ((uint32_t)x1 << 1);
  const uint32_t p1 = ((uint32_t)x2 & 1u) ^ ((uint32_t)x3 << 1);
  const uint32_t p2 = ((uint32_t)x4 & 1u) ^ ((uint32_t)x5 << 1);
  const uint32_t p3 = ((uint32_t)x6 & 1u) ^ ((uint32_t)x7 << 1);
  const uint32_t w = __byte_perm(__byte_perm(p0, p1, 0x0040), __byte_perm(p2, p3, 0x0040), 0x5410);
  return (w & 0x03030303u) << (2 * t);
}

// The block's shared memory, carved from the dynamic allocation rounded up
// to kAlign: [mbarriers] [the resident matrix] [ring slots] [two buffers
// of output rows].
struct Layout {
  int box_bytes, a_bytes, b_chunk, slot_bytes, b_res_bytes, out_stride, out_bytes, ring;
  __host__ __device__ Layout(int box_steps, bool resident, int col_chunks) {
    box_bytes = box_steps * kStep;
    a_bytes = kRows * box_bytes;
    b_chunk = kCols * box_bytes;
    slot_bytes = a_bytes + (resident ? 0 : b_chunk);
    b_res_bytes = resident ? col_chunks * b_chunk : 0;
    ring = resident ? kResidentRing : kStreamRing;
    out_stride = col_chunks * (kCols / 8) + 4;
    out_bytes = kRows * out_stride;
  }
  __host__ __device__ int ring_off() const { return kAlign + b_res_bytes; }
  __host__ __device__ int out_off() const { return ring_off() + ring * slot_bytes; }
  __host__ __device__ int bytes() const { return out_off() + 2 * out_bytes + kAlign; }
};

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
bitplane_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap mmap,
               const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const Layout L(p.box_steps, kResident, p.col_chunks);
  constexpr int R = kResident ? kResidentRing : kStreamRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // R ring barriers, then the matrix's
  uint8_t* b_res = smem + kAlign;
  uint8_t* ring = smem + L.ring_off();
  uint8_t* out_s = smem + L.out_off();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ksteps = p.words >> 3;
  const int sw = L.box_bytes;
  const int batch = blockIdx.x / p.chunks;
  const int chunk = blockIdx.x % p.chunks;
  const int tile0 = (int)((int64_t)chunk * p.row_tiles / p.chunks);
  const int tile1 = (int)((int64_t)(chunk + 1) * p.row_tiles / p.chunks);
  const int col0 = blockIdx.y * p.col_chunks * kCols;
  const int col_valid = min(p.col_chunks * kCols, p.cols - col0);
  const int a_row0 = batch * p.rows;                             // the entry's first row in A
  const int m_row0 = (p.per_batch ? batch * p.cols : 0) + col0;  // its first column in M
  const int out_row_bytes = p.cols >> 3;
  uint8_t* out = p.out + ((int64_t)batch * p.rows) * out_row_bytes + (col0 >> 3);
  const int n_items = (tile1 - tile0) * p.stages;

  // item it: row tile tile0 + it / stages, its stage it % stages (box_steps
  // k256 steps from step (it % stages) * box_steps)
  auto issue = [&](int it) {
    const int tt = it / p.stages, s = it - tt * p.stages;
    uint8_t* slot = ring + (it % R) * L.slot_bytes;
    uint64_t* bar = full + (it % R);
    mbar_expect(bar, L.slot_bytes);
    tma_load(slot, &amap, s * L.box_bytes, a_row0 + (tile0 + tt) * kRows, bar);
    if (!kResident) tma_load(slot + L.a_bytes, &mmap, s * L.box_bytes, m_row0, bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= R; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (kResident) {
      mbar_expect(full + R, L.b_res_bytes);
      for (int c = 0; c < p.col_chunks; ++c)
        tma_load(b_res + c * L.b_chunk, &mmap, 0, m_row0 + c * kCols, full + R);
    }
    for (int it = 0; it < min(R, n_items); ++it) issue(it);
  }
  __syncthreads();
  if (kResident) mbar_wait(full + R, 0);

  // the output rows: a thread copies unit q of rows r0, r0 + step, … in
  // the widest unit that divides an output row (col0 / 8 is a multiple of
  // 16, so it divides the block's bytes too)
  const int u = (out_row_bytes & 3) == 0 ? 4 : (out_row_bytes & 1) == 0 ? 2 : 1;
  const int per_row = (col_valid >> 3) / u;
  const int step = kThreads / per_row;
  const int r0 = tid / per_row, qu = (tid - r0 * per_row) * u;

  int d[64];
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    const int tt = it / p.stages, s = it - tt * p.stages;
    const int row0 = (tile0 + tt) * kRows;
    const uint8_t* slot = ring + (it % R) * L.slot_bytes;
    mbar_wait(full + (it % R), (it / R) & 1);
    const int kn = min(p.box_steps, ksteps - s * p.box_steps);
    uint8_t* stage_out = out_s + (tt & 1) * L.out_bytes;
#pragma unroll 1
    for (int c = 0; c < p.col_chunks; ++c) {
      const uint8_t* bp = kResident ? b_res + c * L.b_chunk : slot + L.a_bytes;
      wgmma_fence();
#pragma unroll 1
      for (int kk = 0; kk < kn; ++kk)  // the first step of a row tile starts the sums
        wgmma_b1(d, wgmma_desc(slot + kk * kStep, sw), wgmma_desc(bp + kk * kStep, sw),
                 s > 0 || kk > 0);
      wgmma_commit_wait();
      if (s != p.stages - 1) continue;
      // d[4j + e]: row 16 warp + g (+ 8 for e >= 2), column 8j + 2t + (e & 1);
      // word q of a row holds n8 tiles 4q … 4q+3, a byte each, and this
      // lane's two bits of each byte are bits 2t and 2t + 1
      // (words past the block's columns are left unset: never stored)
      const int words_here = (col_valid - c * kCols + 31) >> 5;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lo[q] = hi[q] = 0u;
        if (q >= words_here) continue;
        const int j = 4 * q;
        lo[q] = lane_word(d[4 * j], d[4 * j + 1], d[4 * j + 4], d[4 * j + 5], d[4 * j + 8],
                          d[4 * j + 9], d[4 * j + 12], d[4 * j + 13], t);
        hi[q] = lane_word(d[4 * j + 2], d[4 * j + 3], d[4 * j + 6], d[4 * j + 7], d[4 * j + 10],
                          d[4 * j + 11], d[4 * j + 14], d[4 * j + 15], t);
        lo[q] |= __shfl_xor_sync(0xffffffffu, lo[q], 1);
        lo[q] |= __shfl_xor_sync(0xffffffffu, lo[q], 2);
        hi[q] |= __shfl_xor_sync(0xffffffffu, hi[q], 1);
        hi[q] |= __shfl_xor_sync(0xffffffffu, hi[q], 2);
      }
      // lane t keeps word t (columns 32t … 32t+31 of the chunk) of its rows
      const uint32_t wlo = t == 0 ? lo[0] : t == 1 ? lo[1] : t == 2 ? lo[2] : lo[3];
      const uint32_t whi = t == 0 ? hi[0] : t == 1 ? hi[1] : t == 2 ? hi[2] : hi[3];
      const int off = c * (kCols / 8) + 4 * t;
      *reinterpret_cast<uint32_t*>(stage_out + (16 * warp + g) * L.out_stride + off) = wlo;
      *reinterpret_cast<uint32_t*>(stage_out + (16 * warp + g + 8) * L.out_stride + off) = whi;
    }
    // the slot's products are complete: refill it
    if (tid == 0 && it + R < n_items) issue(it + R);
    if (s != p.stages - 1) continue;
    // one barrier a row tile: the output rows alternate between two
    // buffers, and this barrier also follows every thread's copy of the
    // row tile before last
    __syncthreads();
    const int rows_here = min(kRows, p.rows - row0);
    if (r0 < step) {
      uint8_t* dst = out + (int64_t)(row0 + r0) * out_row_bytes + qu;
      const uint8_t* src = stage_out + r0 * L.out_stride + qu;
      for (int r = r0; r < rows_here; r += step) {
        if (u == 4)
          *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
        else if (u == 2)
          *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
        else
          *dst = *src;
        dst += (int64_t)step * out_row_bytes;
        src += step * L.out_stride;
      }
    }
  }
}

// ---------------------------------------------------------------- plan

struct Plan {
  int resident, box_steps, stages, ring, chunks, col_tiles, col_chunks, blocks_per_sm, sms;
  int smem;
};

template <bool kResident>
cudaError_t occupancy(int smem, int* blocks) {
  // the attribute is the current device's: set it (to the most a block may
  // have, so that no configuration lowers it for another) before a first use
  cudaError_t e = cudaFuncSetAttribute(bitplane_wgmma<kResident>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bitplane_wgmma<kResident>,
                                                       kThreads, smem);
}

constexpr int kDevices = 64;

cudaError_t make_plan(int batch, int rows, int words, int cols, Plan* q) {
  const int ksteps = words / 8;
  q->resident = ksteps <= kMaxBox && cols <= kResidentCols;
  q->box_steps = q->resident ? (ksteps <= 1 ? 1 : ksteps <= 2 ? 2 : 4) : kMaxBox;
  q->stages = q->resident ? 1 : (ksteps + kMaxBox - 1) / kMaxBox;
  q->ring = q->resident ? kResidentRing : kStreamRing;
  q->col_chunks = q->resident ? (cols + kCols - 1) / kCols : 1;
  q->col_tiles = (cols + q->col_chunks * kCols - 1) / (q->col_chunks * kCols);
  q->smem = Layout(q->box_steps, q->resident, q->col_chunks).bytes();
  // SMs and blocks an SM, found once a device and configuration (a benign
  // race: every writer stores the same value)
  static int sms[kDevices] = {};
  static int occ[kDevices][2][kMaxBox + 1][kResidentCols / kCols + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int& o = occ[dev][q->resident][q->box_steps][q->col_chunks];
  if (!o) {
    int blocks = 0;
    e = q->resident ? occupancy<true>(q->smem, &blocks) : occupancy<false>(q->smem, &blocks);
    if (e != cudaSuccess) return e;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    o = blocks;
  }
  q->sms = sms[dev];
  q->blocks_per_sm = o;
  const int row_tiles = (rows + kRows - 1) / kRows;
  if (q->resident) {
    // one wave: an entry's row tiles cut into as many ranges as the card
    // has block slots for each entry, at least one tile each
    const int64_t slots = (int64_t)q->sms * q->blocks_per_sm;
    const int64_t per = slots / ((int64_t)batch * q->col_tiles);
    q->chunks = (int)std::max((int64_t)1, std::min((int64_t)row_tiles, per));
  } else {
    q->chunks = row_tiles;  // a block a row tile: the matrix streams either way
  }
  return cudaSuccess;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a 2-D byte tensor of ``n`` rows of ``row_bytes``, read in boxes of
// ``box_bytes`` x ``box_rows`` with the swizzle of ``box_bytes``
cudaError_t make_map(CUtensorMap* map, const void* base, int64_t row_bytes, int64_t n,
                     int box_bytes, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_bytes, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz = box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- probe

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A chain of independent 1-bit products on every SM, for the rate the
// card gives them: ``kind`` 0 is mma.sync m16n8k256 (8 accumulators a
// warp, 8 warps a block), 1 wgmma m64n128k256 from shared memory (two
// warpgroups a block, 16 products a commit).  Operands are arbitrary
// bits; the XOR of the accumulators goes to ``out`` (a word a thread).
__global__ void __launch_bounds__(256) probe_mma(int iters, int* out) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 2654435761u + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 40503u + 7 * i;
  int c[8][4] = {};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) mma_b1(c[u], a, b[0], b[1]);
  }
  int s = 0;
  for (int u = 0; u < 8; ++u) s ^= c[u][0] ^ c[u][1] ^ c[u][2] ^ c[u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) probe_wgmma(int iters, int* out) {
  __shared__ __align__(1024) uint8_t As[2][kRows * 128];
  __shared__ __align__(1024) uint8_t Bs[2][kCols * 128];
  for (int i = threadIdx.x; i < 2 * kRows * 128; i += blockDim.x)
    (&As[0][0])[i] = (uint8_t)(i * 37);
  for (int i = threadIdx.x; i < 2 * kCols * 128; i += blockDim.x)
    (&Bs[0][0])[i] = (uint8_t)(i * 11);
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = wgmma_desc(As[wg], 128), db = wgmma_desc(Bs[wg], 128);
  int d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 16; ++u) wgmma_b1(d, da, db, 1);
    wgmma_commit_wait();
  }
  int s = 0;
  for (int i = 0; i < 64; ++i) s ^= d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// a: (batch, rows, words) uint32; m: (cols, words) uint32, or (batch, cols,
// words) with m_batch_stride = cols * words; out: (batch, rows, cols / 8)
// bytes.  words a multiple of 8, cols of 8; the base pointers 16-byte
// aligned; rows, batch, cols > 0.  Launches on ``stream`` and returns the
// launch's cudaGetLastError() (or the error that kept it from launching).
extern "C" int hb_bitplane(const void* a, const void* m, void* out, int batch, int rows,
                           int words, int cols, int64_t m_batch_stride, void* stream) {
  Plan q;
  cudaError_t e = make_plan(batch, rows, words, cols, &q);
  if (e != cudaSuccess) return (int)e;
  const int box_bytes = q.box_steps * kStep;
  const int64_t row_bytes = (int64_t)words * 4;
  CUtensorMap amap, mmap;
  e = make_map(&amap, a, row_bytes, (int64_t)batch * rows, box_bytes, kRows);
  if (e == cudaSuccess)
    e = make_map(&mmap, m, row_bytes, (int64_t)(m_batch_stride ? batch : 1) * cols, box_bytes,
                 kCols);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.rows = rows;
  p.words = words;
  p.cols = cols;
  p.row_tiles = (rows + kRows - 1) / kRows;
  p.chunks = q.chunks;
  p.per_batch = m_batch_stride != 0;
  p.box_steps = q.box_steps;
  p.stages = q.stages;
  p.col_chunks = q.col_chunks;
  p.out = (uint8_t*)out;
  const dim3 grid((unsigned)q.chunks * (unsigned)batch, (unsigned)q.col_tiles);
  if (q.resident)
    bitplane_wgmma<true><<<grid, kThreads, q.smem, (cudaStream_t)stream>>>(amap, mmap, p);
  else
    bitplane_wgmma<false><<<grid, kThreads, q.smem, (cudaStream_t)stream>>>(amap, mmap, p);
  return (int)cudaGetLastError();
}

// The plan hb_bitplane launches for these sizes, into out[0 … 10]: resident
// (1) or streamed (0), k256 steps a box, stages a row tile, ring slots,
// row-tile ranges an entry, column tiles, 128-column chunks a block,
// blocks an SM, SMs, dynamic shared bytes, blocks in the grid.
extern "C" int hb_bitplane_plan(int batch, int rows, int words, int cols, int64_t* out) {
  Plan q;
  cudaError_t e = make_plan(batch, rows, words, cols, &q);
  if (e != cudaSuccess) return (int)e;
  const int64_t v[11] = {q.resident,  q.box_steps,  q.stages,        q.ring,
                         q.chunks,    q.col_tiles,  q.col_chunks,    q.blocks_per_sm,
                         q.sms,       q.smem,       (int64_t)q.chunks * batch * q.col_tiles};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

extern "C" int hb_bitplane_probe(int kind, int blocks, int iters, void* out, void* stream) {
  if (kind == 0)
    probe_mma<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  else
    probe_wgmma<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
