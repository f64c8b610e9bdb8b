// K3: the tier-2 gradient merge, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_tier2_call.kern`
// (wildgaussians_tpu/ops/rasterize_pallas.py:872), reached through
// `_tier2_dense_pallas` (:845) and `_tier2_merge` (:820). It computes, in
// place,
//   sums[r, big_list[j]] += bigs[r, j]   for every row r and pool slot j,
// skipping slots whose index is >= n (the pool's padding). `big_list` is
// sorted and unique (the sort engine builds it from one nonzero scan), so
// no two threads touch one element: no atomics, and the result equals the
// plain version exactly. The TPU kernel placed the values with a one-hot
// matmul on its matrix unit because its scatter was slow; here one thread
// per (row, slot) does the add.
//
// Bound on this card: bytes. Each valid (row, slot) reads its big value and
// its index and reads and writes one element of `sums`: ~16 bytes per
// element against one add, far below the card's operations-per-byte ridge.
// Consecutive threads take consecutive slots of one row, so the reads of
// `bigs` and `big_list` are coalesced; the writes scatter into `sums` at
// ascending addresses.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_tier2_merge returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tier2_merge_kernel(float* __restrict__ sums, long long sums_stride, int n,
                   const float* __restrict__ bigs, long long bigs_stride,
                   const int* __restrict__ big_list, int m, int rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(rows) * m) return;
  const int r = static_cast<int>(i / m);
  const int j = static_cast<int>(i - static_cast<long long>(r) * m);
  const int g = big_list[j];
  if (g < 0 || g >= n) return;
  sums[r * sums_stride + g] += bigs[r * bigs_stride + j];
}

}  // namespace

extern "C" int wg_tier2_merge(float* sums, long long sums_stride, int n,
                              const float* bigs, long long bigs_stride,
                              const int* big_list, int m, int rows, void* stream) {
  const long long total = static_cast<long long>(rows) * m;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tier2_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      sums, sums_stride, n, bigs, bigs_stride, big_list, m, rows);
  return static_cast<int>(cudaGetLastError());
}
