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
// Design (a simple first version): the tile walk of blend_common.cuh (one
// 256-thread block per 16x16 tile, one thread per pixel, entries of the
// attribute-row table [6 + 3 NP, row_stride] staged through shared memory
// in chunks of 256, a block vote for the early exit), accumulating each
// pass's color in registers.
//
// Bound on this card: the walk is ~20 FP32 operations and one exp per
// (pixel, entry) pair against ~(6 + 3 NP) * 4 bytes per entry read once per
// tile, so the kernel is bound by operations (FP32 and the exp's SFU rate),
// not by device-memory bytes. What limits this version instead is latency:
// one block per tile, a serial dependence on T per thread, and the two
// barriers per chunk.
//
// Outputs: colors [NP, T, 256, 3], final_t [T, 256], and walked [T], the
// number of entries the tile needed: up to and including the last pixel's
// crossing entry if every pixel stopped, else `count`.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_blend_fwd returns cudaGetLastError().

#include "blend_common.cuh"

namespace {

using wg::kChunk;
using wg::kPix;

template <int NP>
__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ table, long long row_stride,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 int grid_x, int num_tiles,
                 float* __restrict__ colors, float* __restrict__ final_t,
                 int* __restrict__ walked) {
  constexpr int W = 6 + 3 * NP;
  __shared__ float ent[W][kChunk];
  __shared__ int last_stop;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  float acc[3 * NP];
#pragma unroll
  for (int i = 0; i < 3 * NP; ++i) acc[i] = 0.0f;

  const wg::WalkEnd end = wg::walk_tile<W>(
      table, row_stride, starts[t], counts[t], wg::pixel_x(t, p, grid_x),
      wg::pixel_y(t, p, grid_x), ent, &last_stop, [&](float w, int k) {
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[3 * i + 0] += w * ent[6 + 3 * i + 0][k];
          acc[3 * i + 1] += w * ent[6 + 3 * i + 1][k];
          acc[3 * i + 2] += w * ent[6 + 3 * i + 2][k];
        }
      });
  if (p == 0) walked[t] = end.walked;

#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float* out = colors + (static_cast<long long>(i) * num_tiles + t) * kPix * 3 + p * 3;
    out[0] = acc[3 * i + 0];
    out[1] = acc[3 * i + 1];
    out[2] = acc[3 * i + 2];
  }
  final_t[static_cast<long long>(t) * kPix + p] = end.T;
}

}  // namespace

extern "C" int wg_blend_fwd(const float* table, long long row_stride,
                            const int* starts, const int* counts,
                            int num_tiles, int grid_x, int n_passes,
                            float* colors, float* final_t, int* walked,
                            void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_passes) {
    case 1:
      blend_fwd_kernel<1><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, grid_x, num_tiles, colors, final_t, walked);
      break;
    case 2:
      blend_fwd_kernel<2><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, grid_x, num_tiles, colors, final_t, walked);
      break;
    case 3:
      blend_fwd_kernel<3><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, grid_x, num_tiles, colors, final_t, walked);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
