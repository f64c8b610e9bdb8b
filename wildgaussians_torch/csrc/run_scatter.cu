// P2: the run-scatter probe, hand-written for Hopper (sm_90a).
//
// Replaces the TPU probe kernel `kern` of tools/profiles/probe_sortdesign.py
// (:140, its `pallas_call` :161), which issued one DMA per (chunk c, run e):
//   dst[:, e, c RUN:(c+1) RUN] = src[:, starts[c E + e] : starts[c E + e] + RUN]
// for a u32 src [W, C K + K], i32 starts [C E] and dst [W, E, C RUN]. It
// measures how fast runs of RUN entries scatter from dynamic offsets, the
// write pattern of a counting-scatter sort (and of K5's bucket writes).
//
// Bound on this card: bytes, each run read once and written once, 8 W RUN
// bytes per run against no arithmetic.
//
// Design: every (row, run, 4-column group) is one unit of one flat index
// space, u = (row C E + c E + e) G + group with G = ceil(RUN / 4), so that
// consecutive threads copy consecutive 16-byte groups of one row of a run,
// and a warp copies one run row, or several when the runs are short (RUN 32
// is 8 groups: four run rows a warp). A grid sized to the card (kBlocksPerSM
// blocks on each SM, ~6 of them resident at 40 registers) walks the space
// with a grid stride, each thread loading kUnroll units before it stores
// them, so that every SM keeps ~100 KB of loads in flight. A unit whose source and destination offsets are
// multiples of 4 columns moves as one 16-byte load and store (the starts of
// the probe's configurations are multiples of RUN); any other unit, and the
// last group of a run whose length is not a multiple of 4, moves word by
// word. The index space is decoded with three 32-bit divisions a unit (the
// wrapper keeps it below 2^31 units).
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_run_scatter returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSM = 16;

__global__ void __launch_bounds__(kThreads)
run_scatter_kernel(const uint32_t* __restrict__ src, long long src_stride,
                   const int* __restrict__ starts, int E, int C, int run, int G,
                   unsigned total, uint32_t* __restrict__ dst, long long dst_stride) {
  const unsigned CE = static_cast<unsigned>(C) * E;
  const unsigned step = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < total;
       base += step * kUnroll) {
    uint4 val[kUnroll];
    long long d_off[kUnroll];
    int ncol[kUnroll];   // 4 and aligned: one vector; 1-4: words; 0: no unit
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned u = base + k * step;
      ncol[k] = 0;
      if (u >= total) continue;
      const unsigned rr = u / G;             // row * C E + c E + e
      const unsigned grp = u - rr * G;
      const unsigned row = rr / CE;
      const unsigned ce = rr - row * CE;
      const unsigned c = ce / E;
      const unsigned e = ce - c * E;
      const int col = grp * 4;
      const int n = min(4, run - col);
      const long long s = row * src_stride + __ldg(starts + ce) + col;
      const long long d = row * dst_stride + (static_cast<long long>(e) * C + c) * run + col;
      d_off[k] = d;
      if (n == 4 && ((s | d) & 3) == 0) {
        ncol[k] = 5;
        val[k] = __ldcs(reinterpret_cast<const uint4*>(src + s));
      } else {
        ncol[k] = n;
        val[k].x = __ldcs(src + s);
        val[k].y = n > 1 ? __ldcs(src + s + 1) : 0u;
        val[k].z = n > 2 ? __ldcs(src + s + 2) : 0u;
        val[k].w = n > 3 ? __ldcs(src + s + 3) : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      uint32_t* d = dst + d_off[k];
      if (ncol[k] == 5) {
        __stcs(reinterpret_cast<uint4*>(d), val[k]);
      } else if (ncol[k] > 0) {
        __stcs(d, val[k].x);
        if (ncol[k] > 1) __stcs(d + 1, val[k].y);
        if (ncol[k] > 2) __stcs(d + 2, val[k].z);
        if (ncol[k] > 3) __stcs(d + 3, val[k].w);
      }
    }
  }
}

}  // namespace

extern "C" int wg_run_scatter(const uint32_t* src, long long src_stride, const int* starts,
                              int rows, int E, int C, int run, uint32_t* dst,
                              long long dst_stride, void* stream) {
  if (C <= 0 || E <= 0 || run <= 0 || rows <= 0) return 0;
  const int G = (run + 3) / 4;
  const long long total = static_cast<long long>(rows) * C * E * G;
  if (total >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int blocks = static_cast<int>(want < sms * kBlocksPerSM ? want : sms * kBlocksPerSM);
  run_scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_stride, starts, E, C, run, G, static_cast<unsigned>(total), dst, dst_stride);
  return static_cast<int>(cudaGetLastError());
}
