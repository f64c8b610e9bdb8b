// Shared parts of K5 (radix_pass.cu) and K6 (radix_unpass.cu): the digit of
// a key, the per-block digit counts, their scan into bucket bases and
// per-block offsets, and the stable rank of a block's columns by digit.
//
// Both kernels cut the columns [0, R) into blocks of kChunk consecutive
// columns. A block walks its chunk in kItems tiles of kThreads columns, in
// order; K5's destination of column i with digit d is
//   offsets[block][d] + (columns of digit d before i in the block),
// where offsets[block][d] = bases[d] + (columns of digit d in earlier blocks)
// and bases is the exclusive prefix of the digit totals rounded up to E.
// That is the JAX pass's layout: stable within each bucket, buckets at the
// E-aligned bases. K6 recomputes the same destinations from the same keys.

#pragma once

#include <cuda_runtime.h>

namespace radix {

// the block and its chunk (K5's staged scatter measured the same at 128
// threads; 8,192-column chunks were slower: more registers, fewer blocks in
// flight)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;
constexpr int kMaxB = 32;
constexpr int kScanThreads = 1024;

inline int num_blocks(int R) { return R > 0 ? (R + kChunk - 1) / kChunk : 1; }

// digit p of an f32 integer key, in the JAX package's f32 arithmetic:
// d = floor(k / B^p); d - floor(d / B) B (scale = 1 / B^p, rounded to f32)
__device__ __forceinline__ int digit_of(float key, float scale, int B) {
  const float fB = static_cast<float>(B);
  float d = floorf(key * scale);
  d = d - floorf(d / fB) * fB;
  const int di = static_cast<int>(d);
  return di < 0 ? 0 : (di >= B ? B - 1 : di);
}

// counts[block][d]: the block's columns with digit d (warp-aggregated
// shared-memory atomics)
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ keys, int R, float scale, int B,
             int* __restrict__ counts) {
  __shared__ int hist[kMaxB];
  if (threadIdx.x < B) hist[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    const int d = i < R ? digit_of(keys[i], scale, B) : B;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < B && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < B) counts[blockIdx.x * B + threadIdx.x] = hist[threadIdx.x];
}

// One block of kScanThreads: totals[d] = sum over blocks of counts[.][d];
// when make_bases, bases[d] = exclusive prefix of the totals rounded up to
// E (else bases is read); offsets[b][d] = bases[d] + sum over b' < b of
// counts[b'][d]. Thread t takes digit t % B over a contiguous segment of
// blocks, so every read is a short run of B consecutive ints.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int nblk, int B, int E, int make_bases,
            int* __restrict__ bases, int* __restrict__ offsets, int* __restrict__ totals) {
  __shared__ int part[kScanThreads];
  __shared__ int sbase[kMaxB + 1];
  const int t = threadIdx.x;
  const int segs = kScanThreads / B;
  const int d = t % B;
  const int s = t / B;
  const int per = (nblk + segs - 1) / segs;
  const int b0 = s * per;
  const int b1 = min(nblk, b0 + per);
  int sum = 0;
  if (s < segs) {
    for (int b = b0; b < b1; ++b) sum += counts[b * B + d];
  }
  part[t] = sum;
  __syncthreads();
  if (t < B) {
    int run = 0;
    for (int s2 = 0; s2 < segs; ++s2) {
      const int v = part[s2 * B + t];
      part[s2 * B + t] = run;
      run += v;
    }
    sbase[t] = run;                       // the digit's total, for now
    if (totals != nullptr) totals[t] = run;
  }
  __syncthreads();
  if (t == 0) {
    if (make_bases) {
      int acc = 0;
      for (int k = 0; k < B; ++k) {
        const int size = ((sbase[k] + E - 1) / E) * E;
        sbase[k] = acc;
        bases[k] = acc;
        acc += size;
      }
      sbase[B] = acc;
      bases[B] = acc;
    } else {
      for (int k = 0; k <= B; ++k) sbase[k] = bases[k];
    }
  }
  __syncthreads();
  if (s < segs) {
    int run = sbase[d] + part[t];
    for (int b = b0; b < b1; ++b) {
      offsets[b * B + d] = run;
      run += counts[b * B + d];
    }
  }
}

// The stable ranks of one block's columns, tile by tile. For each tile of
// kThreads columns it calls visit(it, i, key, d, pos) for every column
// i < R of the tile (it: the tile's number, d: the column's digit), where
// pos = first[d] + (columns of digit d before i in the block). With
// first = the block's row of offsets, pos is K5's destination; with
// first = the exclusive prefix of the block's own counts, pos is the
// column's place in the block's chunk sorted stably by digit. Warp w's
// lanes rank themselves by digit with one ballot per digit; lane d < B of
// each warp publishes the warp's count of digit d, and threads d < B turn
// the warps' counts into the tile's warp offsets and advance the block's
// running position of digit d. `first` must be readable by threads d < B;
// `run` and `wbase` are shared arrays of the caller.
template <typename Visit>
__device__ __forceinline__ void for_each_rank(const float* __restrict__ keys, int R,
                                              float scale, int B, const int* first,
                                              int* run, int (*wbase)[kMaxB], Visit visit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x < B) run[threadIdx.x] = first[threadIdx.x];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    const bool valid = i < R;
    const float key = valid ? keys[i] : 0.0f;
    const int d = valid ? digit_of(key, scale, B) : B;
    int rank = 0;
    int mine = 0;
    for (int j = 0; j < B; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, d == j);
      if (d == j) rank = __popc(m & lt);
      if (lane == j) mine = __popc(m);
    }
    // every lane of this warp has read its previous tile's wbase entry
    __syncwarp();
    if (lane < B) wbase[warp][lane] = mine;
    __syncthreads();
    if (threadIdx.x < B) {
      int acc = run[threadIdx.x];
      for (int w = 0; w < kWarps; ++w) {
        const int c = wbase[w][threadIdx.x];
        wbase[w][threadIdx.x] = acc;
        acc += c;
      }
      run[threadIdx.x] = acc;
    }
    __syncthreads();
    if (valid) visit(it, i, key, d, wbase[warp][d] + rank);
  }
}

}  // namespace radix

// The number of blocks for R columns: the caller sizes the [blocks, B]
// counts and offsets scratch with it (each library exports its own copy)
extern "C" int wg_radix_blocks(int R) { return radix::num_blocks(R); }
