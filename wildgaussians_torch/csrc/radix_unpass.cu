// K6: the inverse of one radix-partition pass for a gradient table,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_inv_pass_kernel` (wildgaussians_tpu/ops/partition.py:376),
// built as a pallas_call by `_make_inv_pass_call` (:529) and run by
// `radix_unpartition` (:635), which replays the passes in reverse. Given the
// pass's saved input key row keys [R] and its bases [B+1], and a gradient
// table gin [grows, >= R + B E] in the pass's output order, it writes
//   out[:, i] = gin[:, dest(i)]   (0 where keys[i] is the sentinel),
// where dest is K5's destination, recomputed from the same keys with the same
// per-block counts and scan (radix_common.cuh). A sentinel-keyed column is a
// hole of an earlier pass or an invalid entry: its gradient reads as zero, as
// in the JAX inverse (partition.py:445-457).
//
// Design: K5's count and scan kernels (the bases are the forward's, read, not
// rebuilt), then a gather kernel with K5's ranking that reads each column's
// rows at its destination and writes them at the column's own place. No
// permutation index is kept from the forward: like the JAX inverse, K6 needs
// only the saved key row.
//
// Bound on this card: bytes. It reads the key row once, the live columns of
// gin once and writes out once. Writes and the key reads are coalesced; the
// reads of gin fall in at most B runs per warp.
//
// The launches go on the caller's stream; the kernels allocate nothing (the
// wrapper passes the counts and offsets as scratch) and do not synchronize
// with the host. wg_radix_unpass returns cudaGetLastError().

#include <cmath>

#include "radix_common.cuh"

namespace {

using radix::kMaxB;
using radix::kThreads;
using radix::kWarps;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ gin, long long ld_g, int grows, int R,
              const float* __restrict__ keys, float scale, int B, float sentinel,
              const int* __restrict__ offsets, float* __restrict__ out, long long ld_out) {
  __shared__ int run[kMaxB];
  __shared__ int wbase[kWarps][kMaxB];
  radix::for_each_rank(
      keys, R, scale, B, offsets + blockIdx.x * B, run, wbase,
      [&](int, long long i, float key, int, int dest) {
        const bool hole = key >= sentinel;
        for (int r = 0; r < grows; ++r) {
          out[r * ld_out + i] = hole ? 0.0f : gin[r * ld_g + dest];
        }
      });
}

}  // namespace

extern "C" int wg_radix_unpass(const float* gin, long long ld_g, int grows, const float* keys,
                               int R, int p, int B, float sentinel, const int* bases,
                               float* out, long long ld_out, int* counts, int* offsets,
                               void* stream_ptr) {
  if (B < 2 || B > kMaxB || grows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale = static_cast<float>(1.0 / std::pow(static_cast<double>(B), p));
  const int nblk = radix::num_blocks(R);
  radix::count_kernel<<<nblk, kThreads, 0, stream>>>(keys, R, scale, B, counts);
  // make_bases = 0: the scan reads the forward's bases (E is unused)
  radix::scan_kernel<<<1, radix::kScanThreads, 0, stream>>>(
      counts, nblk, B, 1, 0, const_cast<int*>(bases), offsets, nullptr);
  gather_kernel<<<nblk, kThreads, 0, stream>>>(gin, ld_g, grows, R, keys, scale, B, sentinel,
                                               offsets, out, ld_out);
  return static_cast<int>(cudaGetLastError());
}
