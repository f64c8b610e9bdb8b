// P2: the run-scatter probe, hand-written for Hopper (sm_90a).
//
// Replaces the TPU probe kernel `kern` of tools/profiles/probe_sortdesign.py
// (:140, its `pallas_call` :161), which issued one DMA per (chunk c, run e):
//   dst[:, e, c RUN:(c+1) RUN] = src[:, starts[c E + e] : starts[c E + e] + RUN]
// for a u32 src [W, C K + K], i32 starts [C E] and dst [W, E, C RUN]. It
// measures how fast runs of RUN entries scatter from dynamic offsets, the
// write pattern of a counting-scatter sort (and of K5's bucket writes).
//
// Design (a simple first version): the block (c E + e, j) copies the W rows
// of the run's columns [j S, (j + 1) S), S = kSpan: a run of up to kSpan
// columns is one block, longer runs (the pure-bandwidth control) are split
// over blocks so that they fill the card. Each thread moves 16 bytes a load
// and a store (uint4) where the run's source and destination offsets are
// multiples of 4 columns, else one word at a time. No TMA yet.
//
// Bound on this card: bytes, each run read once and written once, 8 W RUN
// bytes per run against no arithmetic.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_run_scatter returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 4096;   // columns of a run one block copies

__global__ void __launch_bounds__(kThreads)
run_scatter_kernel(const uint32_t* __restrict__ src, long long src_stride,
                   const int* __restrict__ starts, int rows, int E, int C, int run,
                   uint32_t* __restrict__ dst, long long dst_stride) {
  const int ce = blockIdx.x;
  const int c = ce / E;
  const int e = ce - c * E;
  const int lo = blockIdx.y * kSpan;
  const int n = min(kSpan, run - lo);
  const long long s0 = static_cast<long long>(starts[ce]) + lo;
  const long long d0 = static_cast<long long>(e) * C * run + static_cast<long long>(c) * run + lo;
  const bool vec = ((s0 | d0 | src_stride | dst_stride) & 3) == 0;
  for (int r = 0; r < rows; ++r) {
    const uint32_t* s = src + r * src_stride + s0;
    uint32_t* d = dst + r * dst_stride + d0;
    if (vec) {
      const int n4 = n >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads)
        reinterpret_cast<uint4*>(d)[i] = reinterpret_cast<const uint4*>(s)[i];
      for (int i = (n4 << 2) + threadIdx.x; i < n; i += kThreads) d[i] = s[i];
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
    }
  }
}

}  // namespace

extern "C" int wg_run_scatter(const uint32_t* src, long long src_stride, const int* starts,
                              int rows, int E, int C, int run, uint32_t* dst,
                              long long dst_stride, void* stream) {
  if (C <= 0 || E <= 0 || run <= 0 || rows <= 0) return 0;
  dim3 grid(C * E, (run + kSpan - 1) / kSpan);
  run_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_stride, starts, rows, E, C, run, dst, dst_stride);
  return static_cast<int>(cudaGetLastError());
}
