// K4: the static viewer path's tile-blend forward with planar output,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel built by `_make_static_fwd_call`
// (wildgaussians_tpu/ops/rasterize_pallas.py:1472): `_fwd_kernel` (:376) with
// `planar_out=True`, fed by the static renderer's `blend_fn` (:1530). It
// walks each tile's depth-sorted entries exactly as K1 does (the shared walk
// of blend_common.cuh, so its colors and final T equal K1's bit for bit) and
// writes, per tile and color pass i, the planar block
//   out[i, c, t, p] = color_c + final_T bg_c   for c = r, g, b
//   out[i, 3, t, p] = final_T
// of an [NP, 4, T, 256] array, where K1 writes [T, 256, 3] interleaved. The
// background is a device pointer [3], so a viewer that changes it every
// frame needs no host sync; final_T bg_c is rounded, then added, as the
// rasterizer API composes a frame.
//
// Bound on this card: as K1, operations (~20 FP32 operations and one exp per
// (pixel, entry) pair against ~(6 + 3 NP) * 4 bytes per walked entry and
// 16 NP bytes per pixel written). The design is K1's (see blend_fwd.cu): the
// tiles longest first, warps on 8x4 pixel blocks walking only the entries
// that reach them, straight-line batches of steps, the next chunk in flight
// while this one is walked. A warp's 8x4 block writes each plane as 4 whole
// 32-byte sectors, so the planes are stored straight from registers.
//
// `order` [T] is a permutation of the tiles, the order in which blocks take
// them. The launch goes on the caller's stream; the kernel allocates nothing
// and does not synchronize with the host. wg_blend_fwd_planar returns
// cudaGetLastError().

#include "blend_common.cuh"

namespace {

using wg::kPix;

template <int NP>
__global__ void __launch_bounds__(kPix)
blend_fwd_planar_kernel(const float* __restrict__ table, long long row_stride,
                        const int* __restrict__ starts, const int* __restrict__ counts,
                        const int* __restrict__ order, int grid_x, int num_tiles,
                        const float* __restrict__ bg, float* __restrict__ out) {
  constexpr int W = 6 + 3 * NP;
  __shared__ wg::WalkSmem<W> sm;

  const int t = order[blockIdx.x];
  float acc[3 * NP];
#pragma unroll
  for (int i = 0; i < 3 * NP; ++i) acc[i] = 0.0f;

  const wg::WalkEnd end = wg::walk_tile<W>(
      table, row_stride, starts[t], counts[t], t, grid_x, sm,
      [&](const wg::Pair& q, const float* f) {
        if (q.c) {
#pragma unroll
          for (int i = 0; i < 3 * NP; ++i) acc[i] = __fmaf_rn(q.w, f[6 + i], acc[i]);
        }
      });

  const long long plane = static_cast<long long>(num_tiles) * kPix;
  const long long pix = static_cast<long long>(t) * kPix + wg::tile_pixel();
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float* o = out + 4 * i * plane + pix;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c * plane] = __fadd_rn(acc[3 * i + c], __fmul_rn(end.T, bg[c]));
    o[3 * plane] = end.T;
  }
}

}  // namespace

extern "C" int wg_blend_fwd_planar(const float* table, long long row_stride,
                                   const int* starts, const int* counts, const int* order,
                                   int num_tiles, int grid_x, int n_passes,
                                   const float* bg, float* out, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_passes) {
    case 1:
      blend_fwd_planar_kernel<1><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, bg, out);
      break;
    case 2:
      blend_fwd_planar_kernel<2><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, bg, out);
      break;
    case 3:
      blend_fwd_planar_kernel<3><<<num_tiles, kPix, 0, s>>>(
          table, row_stride, starts, counts, order, grid_x, num_tiles, bg, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
