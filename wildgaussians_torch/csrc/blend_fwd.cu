// K1: fused multi-pass tile-blend forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (wildgaussians_tpu/ops/rasterize_pallas.py:376,
// its per-chunk math `_chunk_fwd_math` :252), built as `fwd_call` in
// `_make_pallas_calls` (:952). Semantics are the reference rasterizer's
// (forward.cu): for each pixel, walk its tile's depth-sorted entries in order,
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy        skip if power > 0
//   alpha = min(0.99, op exp(power))                     skip if alpha < 1/255
//   if T (1 - alpha) < 1e-4 the pixel stops; the crossing entry is excluded
//   else C_pass += alpha T color_pass for each of 1-3 passes; T *= 1 - alpha
// and the tile exits once every pixel has stopped. The passes share one
// alpha/T recurrence. The TPU kernel builds T in log space with a triangular
// matmul prefix; here each thread runs the sequential recurrence, which is
// the same function up to rounding.
//
// Bound on this card: per (pixel, entry) pair the walk needs ~20 FP32
// operations and one exp, and per contributing pair 3 FMAs a pass, against
// ~(6 + 3 NP) * 4 bytes per entry read once per tile, so the kernel is bound
// by operations (FP32 and the exp's SFU rate), not by device-memory bytes.
// A walk over every (pixel, entry) pair spends about half of them on pairs
// whose entry reaches no pixel of the pair's warp, and a walk that stages
// and then computes, one block per tile in raster order with a branching
// inner loop, is bound by latency instead: the longest tiles start late,
// nothing is in flight while a chunk is walked, and the exp of one entry
// waits on the last entry's transmittance.
//
// Design: the walk of blend_common.cuh (tiles longest list first, warps on
// 8x4 pixel blocks walking only the entries that reach them, straight-line
// batches of the step K2 also takes its decisions with, the next chunk
// staged by cp.async while this one is walked), accumulating each pass's
// color in registers with one rounding per FMA. The colors of a tile are
// then written through shared memory (an 8x4 block of pixels is 4 runs of
// 96 bytes of the interleaved [256, 3]; the staged copy writes each pass's
// 3 KB as whole lines).
//
// Outputs: colors [NP, T, 256, 3], final_t [T, 256], walked [T], the
// number of entries the tile needed: up to and including the last pixel's
// crossing entry if every pixel stopped, else `count`, and saturated [T], 1
// if every pixel of the tile stopped, else 0 (the TPU kernel's exit
// telemetry: `walked == count` alone cannot tell a tile that never
// saturated from one that saturated on its last entry). `order` [T] is a
// permutation of the tiles, the order in which blocks take them.
// `tile_base` places the T tiles in the whole grid (the TPU kernel's scalar
// `tb`): tile t lies at grid tile tile_base + t, so a shard blends its band
// of tiles at their global pixel coordinates; 0 for the whole grid.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_blend_fwd returns cudaGetLastError().

#include "blend_common.cuh"

namespace {

using wg::kPix;

template <int NP>
__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ table, long long row_stride,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 const int* __restrict__ order, int grid_x, int num_tiles, int tile_base,
                 float* __restrict__ colors, float* __restrict__ final_t,
                 int* __restrict__ walked, int* __restrict__ saturated) {
  constexpr int W = 6 + 3 * NP;
  constexpr int kOut = kPix * 3;   // floats of one pass's colors of a tile
  static_assert(sizeof(wg::WalkSmem<W>::ent) >= NP * kOut * sizeof(float),
                "the colors are staged in the entry buffers");
  __shared__ wg::WalkSmem<W> sm;

  const int t = order[blockIdx.x];
  const int p = threadIdx.x;
  float acc[3 * NP];
#pragma unroll
  for (int i = 0; i < 3 * NP; ++i) acc[i] = 0.0f;

  const wg::WalkEnd end = wg::walk_tile<W>(
      table, row_stride, starts[t], counts[t], tile_base + t, grid_x, sm,
      [&](const wg::Pair& q, const float* f) {
        if (q.c) {
#pragma unroll
          for (int i = 0; i < 3 * NP; ++i) acc[i] = __fmaf_rn(q.w, f[6 + i], acc[i]);
        }
      });
  const int pix = wg::tile_pixel();
  if (p == 0) {
    walked[t] = end.walked;
    saturated[t] = end.saturated ? 1 : 0;
  }
  final_t[static_cast<long long>(t) * kPix + pix] = end.T;

  // the walk's last barrier has freed the entry buffers
  float* out = reinterpret_cast<float*>(sm.ent);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[i * kOut + pix * 3 + c] = acc[3 * i + c];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float* dst = colors + (static_cast<long long>(i) * num_tiles + t) * kOut;
#pragma unroll
    for (int j = p; j < kOut; j += kPix) dst[j] = out[i * kOut + j];
  }
}

}  // namespace

extern "C" int wg_blend_fwd(const float* table, long long row_stride,
                            const int* starts, const int* counts, const int* order,
                            int num_tiles, int grid_x, int tile_base, int n_passes,
                            float* colors, float* final_t, int* walked, int* saturated,
                            void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_passes) {
    case 1:
      blend_fwd_kernel<1><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, tile_base, colors, final_t,
          walked, saturated);
      break;
    case 2:
      blend_fwd_kernel<2><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, tile_base, colors, final_t,
          walked, saturated);
      break;
    case 3:
      blend_fwd_kernel<3><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, tile_base, colors, final_t,
          walked, saturated);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
