// K3: the tier-2 gradient merge, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_tier2_call.kern`
// (wildgaussians_tpu/ops/rasterize_pallas.py:872), reached through
// `_tier2_dense_pallas` (:845) and `_tier2_merge` (:820). It computes, in
// place,
//   sums[r, big_list[j]] += bigs[r, j]   for every row r and pool slot j,
// skipping slots whose index is outside [0, n) (the pool's padding, >= n).
// `big_list` is sorted and unique (the sort engine builds it from one
// nonzero scan), so no two threads touch one element: no atomics, and the
// result equals the plain version exactly. The TPU kernel placed the values
// with a one-hot matmul on its matrix unit because its scatter was slow.
//
// Bound on this card: bytes. Per valid (row, slot) the kernel reads one big
// value and reads and writes one element of `sums`, against one add. The
// pool holds up to 16 % of the slots, so neighbouring big slots lie ~6
// elements apart and most adds touch a 32-byte sector of `sums` of their
// own: the card moves the whole sector each way. So the least traffic is
// the distinct sectors of `sums` that valid slots touch, read and written
// once, plus the values and indices (chip_smoke.py prints this bound beside
// the one that counts 4 bytes each way).
//
// Design: a 2D grid, slot blocks (x) by rows (y), one slot a thread, so no
// thread splits a flat index by a 64-bit division. Consecutive lanes take consecutive slots, so
// the adds that share a sector of `sums` come from one warp instruction. A
// sweep of layouts on the pools of real training steps (PERF.md, section 6)
// kept this one: two slots a thread was 3-5 us faster on full pools but 2
// us slower on the sort engine's pools after an opacity reset (20-29 %
// valid); one slot a thread is no slower than the parent on any pool
// measured. Stopping a block at a padding first slot gained nothing.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_tier2_merge returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tier2_merge_kernel(float* __restrict__ sums, long long sums_stride, int n,
                   const float* __restrict__ bigs, long long bigs_stride,
                   const int* __restrict__ big_list, int m) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const int g = __ldg(big_list + j);
  if (g < 0 || g >= n) return;
  sums[blockIdx.y * sums_stride + g] += __ldg(bigs + blockIdx.y * bigs_stride + j);
}

}  // namespace

extern "C" int wg_tier2_merge(float* sums, long long sums_stride, int n,
                              const float* bigs, long long bigs_stride,
                              const int* big_list, int m, int rows, void* stream) {
  if (m <= 0 || rows <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, rows);
  tier2_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sums, sums_stride, n, bigs, bigs_stride, big_list, m);
  return static_cast<int>(cudaGetLastError());
}
