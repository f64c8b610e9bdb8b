// P1: the early-exit probe, hand-written for Hopper (sm_90a).
//
// Replaces the TPU probe kernel of tools/profiles/probe_cfin.py (`_probe_kernel`
// :27, its `pallas_call` :95): K1's walk with no color read or written, to
// measure how much of each tile's entry list the blend needs. It runs the
// walk of blend_common.cuh (so its stop decisions, and its walked counts,
// are K1's) over the geometry rows 0-5 of the entry table and writes per
// tile, int32 [T, 3]:
//   0  c_fin    256-entry chunks the tile needed, ceil(walked / 256): the
//               chunks up to the last pixel's crossing if every pixel
//               stopped, else all of them; counted from the tile's start
//               (the TPU counted from a 128-aligned floor, a TPU layout
//               matter), in the JAX probe's 256-entry unit whatever the
//               walk stages at once
//   1  n_chunks 256-entry chunks of the tile's list
//   2  walked   entries the tile needed (K1's `walked`)
//
// Bound on this card: operations, as K1 without the color FMAs (~17 FP32
// operations and one exp per (pixel, entry) pair against 24 bytes per
// walked entry). The design is K1's walk (see blend_fwd.cu and
// blend_common.cuh): tiles longest first, warps on 8x4 pixel blocks walking
// only the entries that reach them, the next chunk in flight. `order` [T]
// is a permutation of the tiles, the order in which blocks take them.
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_probe_cfin returns cudaGetLastError().

#include "blend_common.cuh"

namespace {

using wg::kPix;
constexpr int kProbeChunk = 256;   // the JAX probe's chunk

__global__ void __launch_bounds__(kPix)
probe_cfin_kernel(const float* __restrict__ table, long long row_stride,
                  const int* __restrict__ starts, const int* __restrict__ counts,
                  const int* __restrict__ order, int grid_x, int* __restrict__ out) {
  __shared__ wg::WalkSmem<6> sm;
  const int t = order[blockIdx.x];
  const int count = counts[t];
  const wg::WalkEnd end = wg::walk_tile<6>(table, row_stride, starts[t], count, t, grid_x, sm,
                                           [](const wg::Pair&, const float*) {});
  if (threadIdx.x == 0) {
    out[3 * t + 0] = (end.walked + kProbeChunk - 1) / kProbeChunk;
    out[3 * t + 1] = (count + kProbeChunk - 1) / kProbeChunk;
    out[3 * t + 2] = end.walked;
  }
}

}  // namespace

extern "C" int wg_probe_cfin(const float* table, long long row_stride, const int* starts,
                             const int* counts, const int* order, int num_tiles, int grid_x,
                             int* out, void* stream) {
  if (num_tiles <= 0) return 0;
  probe_cfin_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      table, row_stride, starts, counts, order, grid_x, out);
  return static_cast<int>(cudaGetLastError());
}
