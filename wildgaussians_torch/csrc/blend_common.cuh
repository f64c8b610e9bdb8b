// The tile walk that K1 (csrc/blend_fwd.cu), K4 (csrc/blend_fwd_planar.cu) and
// the probe P1 (csrc/probe_cfin.cu) share: the forward recurrence of the
// TPU kernel `_fwd_kernel` (wildgaussians_tpu/ops/rasterize_pallas.py:376, its
// per-chunk math `_chunk_fwd_math` :252), in the reference rasterizer's
// semantics (forward.cu). For each pixel, walk its tile's depth-sorted
// entries in order,
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy        skip if power > 0
//   alpha = min(0.99, op exp(power))                     skip if alpha < 1/255
//   if T (1 - alpha) < 1e-4 the pixel stops; the crossing entry is excluded
//   else the caller's `contrib(w = alpha T, k)` runs; T *= 1 - alpha
// and the tile exits once every pixel has stopped.
//
// One 256-thread block per 16x16 tile, one thread per pixel. The tile's
// entries [start, start+count) of the attribute-row table [W, row_stride]
// are staged through shared memory in chunks of 256 (thread i loads entry i
// of every row: coalesced), then every thread walks the chunk from shared
// memory (a broadcast read). The early exit is a block vote,
// __syncthreads_count(done) == 256, after each chunk.

#pragma once

#include <cuda_runtime.h>

namespace wg {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kChunk = 256;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

struct WalkEnd {
  float T;       // the pixel's transmittance after its last contributing entry
  int walked;    // entries the tile needed: up to and including the last
                 // pixel's crossing entry if every pixel stopped, else count
  int chunks;    // 256-entry chunks staged before the walk ended
};

// The pixel coordinates of thread p of tile t.
__device__ __forceinline__ float pixel_x(int t, int p, int grid_x) {
  return static_cast<float>((t % grid_x) * kTile + p % kTile);
}
__device__ __forceinline__ float pixel_y(int t, int p, int grid_x) {
  return static_cast<float>((t / grid_x) * kTile + p / kTile);
}

// Walks one tile. `ent` is the block's shared [W][kChunk] staging buffer
// (W >= 6: x, y, conic a, b, c, opacity, then what `contrib` reads) and
// `last_stop` a shared int. `contrib(w, k)` is called, in entry order, for
// every entry k of the staged chunk that contributes to this thread's pixel
// with weight w = alpha T. Every thread of the block must call it.
template <int W, typename Contrib>
__device__ __forceinline__ WalkEnd walk_tile(const float* __restrict__ table,
                                             long long row_stride, int start, int count,
                                             float px, float py, float (*ent)[kChunk],
                                             int* last_stop, Contrib&& contrib) {
  const int p = threadIdx.x;
  if (p == 0) *last_stop = -1;
  float T = 1.0f;
  bool done = false;
  int stop_at = -1;
  bool all_done = false;
  int chunks = 0;

  // `all_done`, `base` and `count` are uniform over the block, so every
  // thread reaches the same barriers
  for (int base = 0; base < count && !all_done; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's readers are done with `ent`
    if (p < n) {
      const float* src = table + static_cast<long long>(start) + base + p;
#pragma unroll
      for (int r = 0; r < W; ++r) ent[r][p] = src[r * row_stride];
    }
    __syncthreads();
    ++chunks;
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float dx = ent[0][k] - px;
        const float dy = ent[1][k] - py;
        const float power =
            -0.5f * (ent[2][k] * dx * dx + ent[4][k] * dy * dy) - ent[3][k] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, ent[5][k] * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < kTEps) {
          done = true;
          stop_at = base + k;
          break;
        }
        contrib(alpha * T, k);
        T = test_t;
      }
    }
    all_done = __syncthreads_count(done) == kPix;
  }

  if (all_done) atomicMax(last_stop, stop_at);
  __syncthreads();
  return WalkEnd{T, all_done ? *last_stop + 1 : count, chunks};
}

}  // namespace wg
