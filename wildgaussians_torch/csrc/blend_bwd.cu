// K2: fused multi-pass tile-blend backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_impl` (wildgaussians_tpu/ops/rasterize_pallas.py:501),
// reached through `_bwd_kernel` (:493) and, on a banded megacore grid,
// `_bwd_kernel_banded` (:482); both are built as `bwd_call` in
// `_make_pallas_calls` (:1023). One CUDA block per tile has no bands, so this
// kernel covers both.
//
// For every depth-sorted entry of every tile it writes one column of per-entry
// gradient rows, summed over the tile's 256 pixels:
//   rows 0-5   dmx, dmy, dca, dcb, dcc, dop
//   row  6     dabs = sx * sum|dmx_pix| + sy * sum|dmy_pix| (the fused NDC
//              abs-gradient channel; sx, sy = 0.5 W, 0.5 H)
//   rows 7+3i  dr, dg, db of color pass i (i < NP)
// Per pixel, the forward recurrence runs again in K1's order with K1's
// floors (skip power > 0 and alpha < 1/255; stop at the first entry whose
// inclusive T falls below 1e-4, which is excluded), and the JAX kernel's
// gradient chain (:575-691) follows it, walking forward with
// suffix = total - prefix so that it shares K1's order and early exit:
//   per pass   cg = gc . col, w = alpha T, prefix += w cg,
//              sfx = out . gc - prefix, dcol = gc w
//   dalpha     = T sum(cg) - (sum(sfx) + gt_eff final_T) / (1 - alpha),
//              0 where alpha sits on the 0.99 cap
//   dpower     = dalpha alpha; dmx = dpower (-(ca dx + cb dy)),
//              dmy = dpower (-(cc dy + cb dx)), dca = dpower (-dx^2 / 2),
//              dcb = dpower (-dx dy), dcc = dpower (-dy^2 / 2), dop = dalpha e.
// The rows stay f32 (the JAX package rounds them to f16 pairs, :695-720).
//
// With per-pass cotangents of final T (`gte_pass` [NP, T, 256], the
// partition engine's), 2 NP more rows follow: per pass i, sum|dmx_pix_i| and
// sum|dmy_pix_i| of the gradient of pass i alone,
//   dalpha_i = T cg_i - (sfx_i + gt_eff_i final_T) / (1 - alpha),
// the per-axis abs channels the JAX partition engine sums over its one K2
// launch per pass (rasterize_pallas.py:2426-2438). The other rows are those
// of the summed gradient, computed as without them.
//
// Design (a simple first version): one 256-thread block per 16x16 tile, one
// thread per pixel. The tile's entries are staged through shared memory in
// chunks of 64 (thread i loads entry i of every table row: coalesced). Each
// entry's 7 + 3 NP values are summed over the pixels of a warp with shuffles
// (skipped when no pixel of the warp contributes to the entry), then the
// block's 8 warp sums are added from shared memory and written as one
// coalesced column. Every entry belongs to one tile, so no atomics. The tile
// stops after the chunk in which every pixel has stopped (a block vote, as in
// K1); the entries after it are never written, so the caller passes a zeroed
// output (their gradients are zero: no pixel reaches them).
//
// Bound on this card: per contributing (pixel, entry) pair ~50 + 14 NP FP32
// operations plus one exp, and the pixel sums of 7 + 3 NP values, against
// ~(6 + 3 NP) * 4 bytes read and (7 + 3 NP) * 4 bytes written per entry, so
// it is bound by operations. This version is limited instead by the serial
// walk per thread and the shuffle reductions (5 per value per entry).
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_blend_bwd returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kChunk = 64;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

template <int NP, bool PASS_ABS>
__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ table, long long row_stride,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 int grid_x, int num_tiles,
                 const float* __restrict__ gcol, const float* __restrict__ gte,
                 const float* __restrict__ gte_pass,
                 const float* __restrict__ colors, const float* __restrict__ final_t,
                 float sx, float sy,
                 float* __restrict__ grads, long long grad_stride) {
  constexpr int W = 6 + 3 * NP;
  constexpr int G0 = 7 + 3 * NP;                   // the summed gradient's rows
  constexpr int G = G0 + (PASS_ABS ? 2 * NP : 0);
  __shared__ float ent[W][kChunk];
  __shared__ float part[kWarps][G][kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int start = starts[t];
  const int count = counts[t];
  const float px = static_cast<float>((t % grid_x) * kTile + p % kTile);
  const float py = static_cast<float>((t / grid_x) * kTile + p / kTile);

  // per pixel: each pass's color cotangent, out . gc (the suffix base), the
  // running prefix, and gt_eff * final_T
  float gc[3 * NP];
  float out_dot_g[NP];
  float prefix[NP];
  const long long pix = static_cast<long long>(t) * kPix + p;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const long long o = (static_cast<long long>(i) * num_tiles * kPix + pix) * 3;
    out_dot_g[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gc[3 * i + c] = gcol[o + c];
      out_dot_g[i] += colors[o + c] * gc[3 * i + c];
    }
    prefix[i] = 0.0f;
  }
  const float gte_ft = gte[pix] * final_t[pix];
  float gte_ft_pass[NP];
  if constexpr (PASS_ABS) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      gte_ft_pass[i] = gte_pass[static_cast<long long>(i) * num_tiles * kPix + pix] * final_t[pix];
  }

  float T = 1.0f;
  bool done = false;
  bool all_done = false;

  // `all_done`, `base` and `count` are uniform over the block, so every
  // thread reaches the same barriers and every lane the same shuffles
  for (int base = 0; base < count && !all_done; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's readers are done with ent/part
    if (p < n) {
      const float* src = table + static_cast<long long>(start) + base + p;
#pragma unroll
      for (int r = 0; r < W; ++r) ent[r][p] = src[r * row_stride];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float v[G];
#pragma unroll
      for (int r = 0; r < G; ++r) v[r] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float ca = ent[2][k], cb = ent[3][k], cc = ent[4][k];
        const float dx = ent[0][k] - px;
        const float dy = ent[1][k] - py;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float e = expf(power);
          const float alpha = fminf(kAlphaMax, ent[5][k] * e);
          if (alpha >= kAlphaMin) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < kTEps) {
              done = true;
            } else {
              contrib = true;
              const float w = alpha * T;
              float cg_sum = 0.0f, sfx_sum = 0.0f;
              float cg_pass[NP], sfx_pass[NP];
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                const float cg = gc[3 * i + 0] * ent[6 + 3 * i + 0][k]
                               + gc[3 * i + 1] * ent[6 + 3 * i + 1][k]
                               + gc[3 * i + 2] * ent[6 + 3 * i + 2][k];
                prefix[i] += w * cg;
                sfx_sum += out_dot_g[i] - prefix[i];
                cg_sum += cg;
                cg_pass[i] = cg;
                sfx_pass[i] = out_dot_g[i] - prefix[i];
                v[7 + 3 * i + 0] = gc[3 * i + 0] * w;
                v[7 + 3 * i + 1] = gc[3 * i + 1] * w;
                v[7 + 3 * i + 2] = gc[3 * i + 2] * w;
              }
              float dalpha = T * cg_sum - (sfx_sum + gte_ft) / (1.0f - alpha);
              if (alpha >= kAlphaMax) dalpha = 0.0f;
              const float dpower = dalpha * alpha;
              const float dmx = dpower * (-(ca * dx + cb * dy));
              const float dmy = dpower * (-(cc * dy + cb * dx));
              v[0] = dmx;
              v[1] = dmy;
              v[2] = dpower * (-0.5f * dx * dx);
              v[3] = dpower * (-dx * dy);
              v[4] = dpower * (-0.5f * dy * dy);
              v[5] = dalpha * e;
              v[6] = sx * fabsf(dmx) + sy * fabsf(dmy);
              if constexpr (PASS_ABS) {
#pragma unroll
                for (int i = 0; i < NP; ++i) {
                  float da = T * cg_pass[i] - (sfx_pass[i] + gte_ft_pass[i]) / (1.0f - alpha);
                  if (alpha >= kAlphaMax) da = 0.0f;
                  const float dp = da * alpha;
                  v[G0 + 2 * i + 0] = fabsf(dp * (-(ca * dx + cb * dy)));
                  v[G0 + 2 * i + 1] = fabsf(dp * (-(cc * dy + cb * dx)));
                }
              }
              T = test_t;
            }
          }
        }
      }
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int r = 0; r < G; ++r) {
          float s = v[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
          v[r] = s;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < G; ++r) part[warp][r][k] = v[r];
      }
    }
    // the vote is also the barrier after which `part` is complete
    all_done = __syncthreads_count(done) == kPix;
    for (int idx = p; idx < G * n; idx += kPix) {
      const int r = idx / n;
      const int k = idx - r * n;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][r][k];
      grads[r * grad_stride + start + base + k] = s;
    }
  }
}

template <int NP, bool PASS_ABS>
void launch(const float* table, long long row_stride, const int* starts, const int* counts,
            int num_tiles, int grid_x, const float* gcol, const float* gte,
            const float* gte_pass, const float* colors, const float* final_t, float sx,
            float sy, float* grads, long long grad_stride, cudaStream_t s) {
  blend_bwd_kernel<NP, PASS_ABS><<<num_tiles, kPix, 0, s>>>(
      table, row_stride, starts, counts, grid_x, num_tiles, gcol, gte, gte_pass, colors,
      final_t, sx, sy, grads, grad_stride);
}

}  // namespace

extern "C" int wg_blend_bwd(const float* table, long long row_stride,
                            const int* starts, const int* counts,
                            int num_tiles, int grid_x, int n_passes,
                            const float* gcol, const float* gte, const float* gte_pass,
                            const float* colors, const float* final_t,
                            float sx, float sy,
                            float* grads, long long grad_stride,
                            void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gte_pass == nullptr) {
    switch (n_passes) {
      case 1: launch<1, false>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                               gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      case 2: launch<2, false>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                               gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      case 3: launch<3, false>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                               gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (n_passes) {
      case 1: launch<1, true>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                              gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      case 2: launch<2, true>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                              gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      case 3: launch<3, true>(table, row_stride, starts, counts, num_tiles, grid_x, gcol, gte,
                              gte_pass, colors, final_t, sx, sy, grads, grad_stride, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
