// The GF(2) bit-plane product over packed bits, for Hopper (sm_90a):
//     out[b, t, c] = parity(popc(a[b, t, :] & m[b, c, :]))
// with both operands packed 32 bits a word along the contraction axis
// (word w holds bits 32w … 32w+31, LSB first) and the output packed too,
// 8 columns a byte (column c is bit c % 8 of byte c / 8 of its row).
//
// Replaces: hbbft_tpu/ops/gf256.py :: gf_apply_bitmatrix (and gf16.py's,
// which is the same product), the int8 x int8 -> int32 MXU matmul at
// hbbft_tpu/ops/gf256.py:316, with the parity taken afterwards.  A constant
// GF(2^8) or GF(2^16) matrix applied to shard symbols is this product: the
// RBC's encode and re-encode, its survivor decode (one matrix per batch
// entry: m_batch_stride != 0) and the host coder's ``device`` backend.
//
// What bounds it on this card: the ALU pipe.  Each (row, column, word)
// costs one LOP3 (acc ^= a & m), and Hopper issues 32-bit logic at 64
// lanes a clock per SM; the popcount a (row, column) is 1/words of that.
// The packed matrix is 1/32 of the float32 0/1 matrix the plain version
// multiplies (1.91 GB instead of 61 GB for the N = 16384 parity matrix), so
// at the epochs' shapes its bytes take a third of the LOP3 time or less:
// the matrix is read once per block row of 64 data rows, 8 words at a time.
//
// Design: a block owns 64 data rows x 256 output columns.  Each stage
// stages 8 contraction words of both in shared memory, word-major (A as
// [word][row], M as [word][column]), through registers: the next stage's
// global loads are issued before this stage's products, so they are in
// flight while it computes.  Warp w owns rows 8w … 8w+7 and lane l the
// columns l + 32j (j < 8): a thread holds an 8 x 8 tile of 32-bit XOR
// accumulators, reads its 8 row words with two broadcast 16-byte loads and
// its 8 column words conflict-free, and issues 64 LOP3 for those 10 loads.
// At the end each accumulator's parity goes into a warp ballot, whose 32
// bits are the parities of 32 neighbouring columns of one row: 4 output
// bytes, written by one lane.  The matrix is stored column by column with
// the contraction words contiguous, so a warp's loads of it are 16 columns
// x 32 contiguous bytes.  Tensor cores, TMA and the 1-bit mma are not used.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // data rows a block
constexpr int kCols = 256;         // output columns a block
constexpr int kWords = 8;          // contraction words a stage; callers pad to a multiple
constexpr int kThreads = 256;      // 8 warps x 8 rows, 32 lanes x 8 columns
constexpr int kTile = 8;           // a thread's rows, and its columns
constexpr int kAStride = kRows + 4;   // [word][row]: 16-byte aligned rows of 68 words
constexpr int kMStride = kCols + 4;   // [word][column]: the staging stores hit 32 banks

__global__ void __launch_bounds__(kThreads, 2)
bitplane_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ m,
                uint8_t* __restrict__ out, int rows, int words, int cols, int row_tiles,
                int64_t m_batch_stride) {
  __shared__ __align__(16) uint32_t As[kWords * kAStride];
  __shared__ __align__(16) uint32_t Ms[kWords * kMStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t batch = blockIdx.x / row_tiles;
  const int row0 = (int)(blockIdx.x % row_tiles) * kRows;
  const int col0 = blockIdx.y * kCols;
  const int out_row_bytes = cols >> 3;
  a += batch * rows * (int64_t)words;
  m += batch * m_batch_stride;
  out += batch * rows * (int64_t)out_row_bytes;

  // staging: A's 64 rows x 8 words are 128 16-byte pieces, one a thread
  // of the first 128 (a warp takes 32 rows of one 4-word part, so its
  // stores hit 32 banks); M's 256 columns x 8 words are 512 pieces, two a
  // thread (a warp takes 16 columns x 2 parts, 32 contiguous bytes a
  // column)
  const bool a_stager = tid < 2 * kRows;
  const int a_row = tid & (kRows - 1), a_part = (tid >> 6) & 1;
  const bool a_ok = a_stager && row0 + a_row < rows;
  const uint4* a_src = reinterpret_cast<const uint4*>(
      a + (int64_t)(a_ok ? row0 + a_row : 0) * words) + a_part;
  const int m_col = tid >> 1, m_part = tid & 1;
  const uint4* m_src = reinterpret_cast<const uint4*>(m + (int64_t)col0 * words) + m_part;
  bool m_ok[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) m_ok[q] = col0 + q * 128 + m_col < cols;

  uint4 ra = make_uint4(0, 0, 0, 0), rm[2];
  auto load = [&](int stage) {
    const int off = stage * (kWords / 4);
    if (a_ok) ra = a_src[off];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      rm[q] = make_uint4(0, 0, 0, 0);
      if (m_ok[q]) rm[q] = m_src[(int64_t)(q * 128 + m_col) * (words / 4) + off];
    }
  };

  uint32_t acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0u;

  const int stages = words / kWords;
  load(0);
  for (int s = 0; s < stages; ++s) {
    __syncthreads();  // the previous stage's reads are done
    if (a_stager) {
      uint32_t* dst = As + (a_part * 4) * kAStride + a_row;
      dst[0] = ra.x; dst[kAStride] = ra.y; dst[2 * kAStride] = ra.z; dst[3 * kAStride] = ra.w;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t* dst = Ms + (m_part * 4) * kMStride + q * 128 + m_col;
      dst[0] = rm[q].x; dst[kMStride] = rm[q].y;
      dst[2 * kMStride] = rm[q].z; dst[3 * kMStride] = rm[q].w;
    }
    __syncthreads();
    if (s + 1 < stages) load(s + 1);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(As + w * kAStride + warp * kTile);
      const uint4 a1 = *reinterpret_cast<const uint4*>(As + w * kAStride + warp * kTile + 4);
      const uint32_t av[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      uint32_t mv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) mv[j] = Ms[w * kMStride + j * 32 + lane];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] ^= av[i] & mv[j];
    }
  }

  // bit l of ballot (i, j) is the parity of column col0 + 32j + l in row
  // row0 + 8 warp + i; lane 8 (i % 4) + j keeps ballots (i, j) for i < 4
  // and i >= 4
  uint32_t keep[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const uint32_t bits = __ballot_sync(0xffffffffu, __popc(acc[i][j]) & 1);
      if (lane == (i & 3) * kTile + j) keep[i >> 2] = bits;
    }
  const int j = lane & (kTile - 1);
  const int col = col0 + 32 * j;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * kTile + h * 4 + (lane >> 3);
    if (row >= rows || col >= cols) continue;
    uint8_t* dst = out + (int64_t)row * out_row_bytes + (col >> 3);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + 8 * q < cols) dst[q] = (uint8_t)(keep[h] >> (8 * q));
  }
}

}  // namespace

// a: (batch, rows, words) uint32; m: (cols, words) uint32, or (batch, cols,
// words) with m_batch_stride = cols * words; out: (batch, rows, cols / 8)
// bytes.  words a multiple of 8, cols of 8; the base pointers 16-byte
// aligned; rows, batch > 0.  Launches on ``stream`` and returns the launch's
// cudaGetLastError().
extern "C" int hb_bitplane(const void* a, const void* m, void* out, int batch, int rows,
                           int words, int cols, int64_t m_batch_stride, void* stream) {
  const int row_tiles = (rows + kRows - 1) / kRows;
  const dim3 grid((unsigned)row_tiles * (unsigned)batch, (unsigned)((cols + kCols - 1) / kCols));
  bitplane_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)m, (uint8_t*)out, rows, words, cols, row_tiles,
      m_batch_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* hb_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
