// K5: one stable radix-partition pass, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pass_kernel` (wildgaussians_tpu/ops/partition.py:173),
// built as a pallas_call by `_make_pass_call` (:338) and run by
// `radix_partition` (:569). For a table [rows, R] f32 whose key row holds
// exact integer keys, and digit p of base B, the pass writes [rows, R_out]:
//   - column i, whose key has digit d, moves to
//     bases[d] + (number of earlier columns with digit d), every row with it;
//   - bases[d] is the exclusive prefix of the digit totals, each rounded up
//     to E (the JAX kernel's E-aligned bucket regions);
//   - each bucket's gap [bases[d] + total[d], bases[d+1]) and the tail
//     [bases[B], R_out) hold sentinel entries: key row = sentinel, other rows 0.
// The key row of the input is taken from `keys` (the caller's remapped key
// row), so the caller never copies the table to remap it. Payload of
// sentinel-keyed columns is moved like any other (the JAX kernel zeroes it
// in chunks that hold only sentinels; nothing reads it).
//
// Design (radix_common.cuh for the counts, the scan and the ranks): a count
// kernel writes each block's digit histogram; one scan block turns them into
// the bases and each block's running offsets; the scatter kernel moves the
// columns; the fill kernel writes the sentinel gaps and tail. The TPU
// kernel's per-bucket VMEM rings, one-hot matmul permutation and E-aligned
// DMA flushes are layout choices of the TPU and have no counterpart here.
//
// Bound on this card: bytes. The pass reads the table and the key row once
// and writes the table once: ~8 bytes per element against a few integer
// operations, far below the operations-per-byte ridge. Written straight to
// their destinations, a warp's 32 consecutive columns would fall into up to
// 16 runs of ~2 floats each, and the write transactions, not the bytes,
// would set the time (~25 % of the bound on this card). So the scatter
// kernel stages: each block takes a chunk of kChunk columns,
//   1. ranks them stably by digit (one ballot per digit per warp), keeping
//      each column's place in the chunk sorted by digit in registers and
//      the digit of each sorted place in shared memory;
//   2. per row, loads the row's columns (coalesced; the next row's loads are
//      issued before this row's writes), permutes them into digit order in
//      one of two shared buffers, and writes the buffer out: thread j writes
//      sorted place j, so consecutive threads write consecutive destinations
//      within each digit's run (~kChunk / B floats: ~256 at B = 16).
// Two buffers need one barrier per row: a buffer is written again only two
// rows later, after the next row's barrier.
//
// The launches go on the caller's stream; the kernels allocate nothing (the
// wrapper passes the counts, offsets and totals as scratch) and do not
// synchronize with the host. wg_radix_pass returns cudaGetLastError().

#include <cmath>

#include "radix_common.cuh"

namespace {

using radix::kChunk;
using radix::kItems;
using radix::kMaxB;
using radix::kThreads;
using radix::kWarps;

// two [kChunk] f32 row buffers, then the digit of each sorted place; under
// the 48 KB a launch gets without cudaFuncSetAttribute
constexpr int kScatterSmem = 2 * kChunk * 4 + kChunk;
static_assert(kScatterSmem <= 48 * 1024, "the scatter's shared memory needs opting in");

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ in, long long ld_in, int rows, int R,
               const float* __restrict__ keys, int key_row, float scale, int B,
               const int* __restrict__ counts, const int* __restrict__ offsets,
               float* __restrict__ out, long long ld_out) {
  extern __shared__ float stage[];
  unsigned char* sdig = reinterpret_cast<unsigned char*>(stage + 2 * kChunk);
  __shared__ int first[kMaxB];   // the chunk's sorted place of each digit's first column
  __shared__ int shift[kMaxB];   // destination - sorted place, per digit
  __shared__ int run[kMaxB];
  __shared__ int wbase[kWarps][kMaxB];
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), R - base));
  if (tid == 0) {
    int acc = 0;
    for (int d = 0; d < B; ++d) {
      first[d] = acc;
      shift[d] = offsets[blockIdx.x * B + d] - acc;
      acc += counts[blockIdx.x * B + d];
    }
  }
  __syncthreads();

  // 1. each column's sorted place, and each sorted place's digit
  int place[kItems];
  radix::for_each_rank(keys, R, scale, B, first, run, wbase,
                       [&](int it, long long, float, int d, int pos) {
                         place[it] = pos;
                         sdig[pos] = static_cast<unsigned char>(d);
                       });
  __syncthreads();
  int dest[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int j = it * kThreads + tid;
    dest[it] = j < n ? shift[sdig[j]] + j : 0;
  }

  // 2. row by row through the two buffers; v holds row r's columns
  float v[kItems];
  const float* src = key_row == 0 ? keys : in;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int c = it * kThreads + tid;
    v[it] = c < n ? src[base + c] : 0.0f;
  }
  for (int r = 0; r < rows; ++r) {
    float* buf = stage + (r & 1) * kChunk;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (it * kThreads + tid < n) buf[place[it]] = v[it];
    }
    if (r + 1 < rows) {
      src = r + 1 == key_row ? keys : in + (r + 1) * ld_in;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int c = it * kThreads + tid;
        v[it] = c < n ? src[base + c] : 0.0f;
      }
    }
    __syncthreads();
    float* dst = out + r * ld_out;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int j = it * kThreads + tid;
      if (j < n) dst[dest[it]] = buf[j];
    }
  }
}

// the sentinel entries: every column of [0, R_out) that no real column fills
__global__ void __launch_bounds__(kThreads)
fill_kernel(int rows, int R_out, int key_row, float sentinel, int B,
            const int* __restrict__ bases, const int* __restrict__ totals,
            float* __restrict__ out, long long ld_out) {
  __shared__ long long gstart[kMaxB + 1];
  __shared__ long long gpre[kMaxB + 2];
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int s = 0; s <= B; ++s) {
      const long long start = s < B ? static_cast<long long>(bases[s]) + totals[s] : bases[B];
      const long long end = s < B ? bases[s + 1] : R_out;
      gstart[s] = start;
      gpre[s] = acc;
      acc += end - start;
    }
    gpre[B + 1] = acc;
  }
  __syncthreads();
  const long long total = gpre[B + 1];
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    int s = 0;
    while (t >= gpre[s + 1]) ++s;
    const long long pos = gstart[s] + (t - gpre[s]);
    for (int r = 0; r < rows; ++r) out[r * ld_out + pos] = r == key_row ? sentinel : 0.0f;
  }
}

}  // namespace

extern "C" int wg_radix_pass(const float* in, long long ld_in, int rows, int R,
                             const float* keys, int key_row, int p, int B, int E,
                             float sentinel, float* out, long long ld_out, int R_out,
                             int* bases, int* counts, int* offsets, int* totals,
                             void* stream_ptr) {
  if (B < 2 || B > kMaxB || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale = static_cast<float>(1.0 / std::pow(static_cast<double>(B), p));
  const int nblk = radix::num_blocks(R);
  radix::count_kernel<<<nblk, kThreads, 0, stream>>>(keys, R, scale, B, counts);
  radix::scan_kernel<<<1, radix::kScanThreads, 0, stream>>>(counts, nblk, B, E, 1, bases,
                                                            offsets, totals);
  scatter_kernel<<<nblk, kThreads, kScatterSmem, stream>>>(
      in, ld_in, rows, R, keys, key_row, scale, B, counts, offsets, out, ld_out);
  const long long gaps = static_cast<long long>(R_out) - R;   // every pass adds B E (+ tail)
  if (gaps > 0) {
    const long long want = (gaps + kThreads - 1) / kThreads;
    const int fill_blocks = static_cast<int>(want < 1024 ? want : 1024);
    fill_kernel<<<fill_blocks, kThreads, 0, stream>>>(rows, R_out, key_row, sentinel, B, bases,
                                                      totals, out, ld_out);
  }
  return static_cast<int>(cudaGetLastError());
}
