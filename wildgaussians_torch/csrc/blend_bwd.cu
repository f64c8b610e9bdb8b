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
// partition engine's), 2 more rows follow: sum over the passes i and the
// pixels of |dmx_i| and of |dmy_i|, the gradient of pass i alone,
//   dalpha_i = T cg_i - (sfx_i + gt_eff_i final_T) / (1 - alpha),
// the per-axis abs channels the JAX partition engine sums over its one K2
// launch per pass (rasterize_pallas.py:2426-2438). The other rows are those
// of the summed gradient, computed as without them, bit for bit.
//
// Bound on this card: per contributing (pixel, entry) pair ~50 + 14 NP FP32
// operations plus one exp, and the pixel sums of 7 + 3 NP values, against
// ~(6 + 3 NP) * 4 bytes read and (7 + 3 NP) * 4 bytes written per entry, so
// it is bound by operations. Walked naively (every pixel over every entry,
// each entry's G values summed over each warp with 5 shuffles apiece), most
// issue slots go to the shuffles and to pairs that contribute nothing, and
// each tile's entries form one long chain of dependent latencies.
//
// `tile_base` places the T tiles in the whole grid, as K1's does: tile t
// lies at grid tile tile_base + t (a shard's band); 0 for the whole grid.
//
// Design: one 256-thread block per 16x16 tile, one thread per pixel; each
// warp holds an 8x4 block of the tile's pixels. Blocks take the tiles in
// the order the caller gives, longest list first, so that the longest
// serial walks start at once and the short ones fill the card around them.
// The tile's entries are staged through shared memory in chunks of 64
// (coalesced: entry e of every table row by thread e, kept entry-major for
// 16-byte reads) with, for each (entry, warp), whether the entry's alpha can
// reach 1/255 on the warp's pixels (`wg::reaches` of blend_common.cuh, the
// test K1's walk makes); the next chunk is staged while
// the block sums the last one, two barriers a chunk. Each warp walks only
// the entries that reach its block, and none once its pixels have stopped
// (both uniform over the warp), in two phases:
//   1. the forward recurrence: alpha, K1's skips and stop, T before the
//      entry (K1's own step, `wg::blend_pair`, so that the two kernels take
//      every decision alike) and the per-pass prefixes (the only values
//      carried from entry to entry);
//   2. if any pixel of the warp contributes, the gradient values, as
//      straight-line code (zero where the pixel does not contribute), then
//      the warp's sums of the first 16 rows by a reduce-scatter butterfly
//      (16 shuffles: lane 2m ends with row m's sum) and of any further rows
//      by 5 shuffles each, stored to shared memory ([warp][row][entry],
//      padded against bank conflicts).
// After the chunk the block adds the warps' sums of every (row, entry),
// zero for a warp that stored none, and writes the chunk's rows coalesced.
// Every entry belongs to one tile, so no atomics. The tile stops after the
// chunk in which every pixel has stopped (a block vote, as in K1); the
// entries after it are never written, so the caller passes a zeroed output
// (their gradients are zero: no pixel reaches them). At most 48 registers a
// thread (five blocks per SM; a few bytes spill): the walk is bound by
// latency, and more warps in flight hide more of it.
// Every operation that feeds the rows is a round-to-nearest intrinsic
// (__fmaf_rn, __fmul_rn, ...), which the compiler neither fuses nor splits:
// the summed rows are one sequence of roundings in every instantiation, so
// they stay bit for bit the same with the abs rows. 1 / (1 - alpha) is one
// fast reciprocal per pair (__fdividef, 1 - alpha in [0.01, 1]: within 2
// ulp; the plain version divides, so the rows differ in the last bits).
//
// The launch goes on the caller's stream; the kernel allocates nothing and
// does not synchronize with the host. wg_blend_bwd returns cudaGetLastError().

#include <cmath>

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using wg::kAlphaMax;
using wg::kFull;
using wg::kPix;
using wg::kTile;
using wg::kWarpH;
using wg::kWarpW;
using wg::kWarps;
constexpr int kChunk = 64;
constexpr int kFan = 16;          // the rows the butterfly sums

// One step of the butterfly: the lanes with bit 2H set keep values [H, 2H)
// and send [0, H) to their partner across that bit, the others the reverse;
// each ends with its kept half plus the partner's in v[0, H).
template <int H>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool upper = (lane & (2 * H)) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 2 * H));
  }
}

// The warp's sums of v[0, 16) in 8 + 4 + 2 + 1 + 1 = 16 shuffles: afterwards
// v[0] of lane l holds the sum over the 32 lanes of value (l >> 1) & 15. The
// additions of one value do not depend on the others.
__device__ __forceinline__ void reduce_scatter16(float* v, int lane) {
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], 1));
}

// at most 48 registers a thread: five blocks per SM
template <int NP, bool PASS_ABS>
__global__ void __launch_bounds__(kPix, 5)
blend_bwd_kernel(const float* __restrict__ table, long long row_stride,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 const int* __restrict__ order, int grid_x, int num_tiles, int tile_base,
                 const float* __restrict__ gcol, const float* __restrict__ gte,
                 const float* __restrict__ gte_pass,
                 const float* __restrict__ colors, const float* __restrict__ final_t,
                 float sx, float sy,
                 float* __restrict__ grads, long long grad_stride) {
  constexpr int W = 6 + 3 * NP;
  constexpr int G0 = 7 + 3 * NP;                   // the summed gradient's rows
  constexpr int G = G0 + (PASS_ABS ? 2 : 0);
  constexpr int GF = G < kFan ? G : kFan;          // rows of the butterfly
  constexpr int GV = G < kFan ? kFan : G;          // values per thread, zero-padded
  constexpr int W4 = (W + 3) / 4;                  // float4s per staged entry
  __shared__ float4 ent[kChunk][W4];
  __shared__ bool reach[kChunk][kWarps];
  __shared__ float part[kWarps][G][kChunk + 1];
  __shared__ unsigned long long wrote[kWarps];   // the entries each warp's part holds

  const int t = order[blockIdx.x];
  const int tg = tile_base + t;   // the tile's place in the whole grid
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int start = starts[t];
  const int count = counts[t];
  // the warp's block of pixels, and this thread's pixel in it
  const int wx = (warp % (kTile / kWarpW)) * kWarpW;
  const int wy = (warp / (kTile / kWarpW)) * kWarpH;
  const int lx = wx + lane % kWarpW;
  const int ly = wy + lane / kWarpW;
  const float px = static_cast<float>((tg % grid_x) * kTile + lx);
  const float py = static_cast<float>((tg / grid_x) * kTile + ly);

  // per pixel: each pass's color cotangent, out . gc (the suffix base), the
  // running prefix, and gt_eff * final_T (and each pass's)
  float gc[3 * NP];
  float out_dot_g[NP];
  float prefix[NP];
  float gte_ft_pass[NP];
  const long long pix = static_cast<long long>(t) * kPix + ly * kTile + lx;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const long long o = (static_cast<long long>(i) * num_tiles * kPix + pix) * 3;
    out_dot_g[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gc[3 * i + c] = gcol[o + c];
      out_dot_g[i] = __fmaf_rn(colors[o + c], gc[3 * i + c], out_dot_g[i]);
    }
    prefix[i] = 0.0f;
    if constexpr (PASS_ABS)
      gte_ft_pass[i] = __fmul_rn(gte_pass[static_cast<long long>(i) * num_tiles * kPix + pix],
                                 final_t[pix]);
  }
  const float gte_ft = __fmul_rn(gte[pix], final_t[pix]);

  float T = 1.0f;
  bool done = false;

  // stages the chunk of entries [c, c + kChunk) of the tile: the entries,
  // and for each entry and warp whether the entry can reach the warp's
  // pixels (two pairs a thread, the geometry read through the cache)
  const float tx0 = static_cast<float>((tg % grid_x) * kTile);
  const float ty0 = static_cast<float>((tg / grid_x) * kTile);
  auto stage = [&](int c) {
    const int m = min(kChunk, count - c);
    const float* src = table + static_cast<long long>(start) + c;
    if (p < m) {
      float* dst = reinterpret_cast<float*>(ent[p]);
#pragma unroll
      for (int r = 0; r < W; ++r) dst[r] = src[r * row_stride + p];
    }
    for (int id = p; id < m * kWarps; id += kPix) {
      const float* e = src + id / kWarps;
      const int w = id % kWarps;
      reach[id / kWarps][w] =
          wg::reaches(e[0], e[row_stride], e[2 * row_stride], e[3 * row_stride],
                  e[4 * row_stride], e[5 * row_stride],
                  tx0 + (w % (kTile / kWarpW)) * kWarpW, ty0 + (w / (kTile / kWarpW)) * kWarpH);
    }
  };

  // `base` and `count` are uniform over the block, so every thread reaches
  // the same barriers (two per chunk); the tests that skip work are uniform
  // over the warp, so every lane reaches the same shuffles
  if (count > 0) stage(0);
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the chunk is staged, and the last chunk's sums are read
    // the warp walks only the chunk's entries that reach its pixels, and
    // none once all its pixels have stopped
    unsigned long long todo =
        static_cast<unsigned long long>(__ballot_sync(kFull, lane < n && reach[lane][warp])) |
        static_cast<unsigned long long>(
            __ballot_sync(kFull, lane + 32 < n && reach[lane + 32][warp])) << 32;
    unsigned long long mine = 0;
    while (todo != 0 && !__all_sync(kFull, done)) {
      const int k = __ffsll(static_cast<long long>(todo)) - 1;
      todo &= todo - 1;
      // the entry: x, y, conic a, b, c, opacity, then each pass's color
      float f[4 * W4];
#pragma unroll
      for (int j = 0; j < W4; ++j) {
        const float4 q4 = ent[k][j];
        f[4 * j] = q4.x;
        f[4 * j + 1] = q4.y;
        f[4 * j + 2] = q4.z;
        f[4 * j + 3] = q4.w;
      }
      // 1. the forward recurrence: K1's step (blend_common.cuh), so that K1
      // and K2 take every skip and stop alike; T and the prefixes
      const wg::Pair q = wg::blend_pair(f[0], f[1], f[2], f[3], f[4], f[5], px, py, T, done);
      const float dx = q.dx, dy = q.dy, e = q.e, alpha = q.alpha, t_at = q.t_at, w = q.w;
      const bool c = q.c;
      const float ca = f[2], cb = f[3], cc = f[4];
      float cg[NP], sfx[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        cg[i] = __fmaf_rn(gc[3 * i + 2], f[8 + 3 * i],
                          __fmaf_rn(gc[3 * i + 1], f[7 + 3 * i], __fmul_rn(gc[3 * i], f[6 + 3 * i])));
        prefix[i] = c ? __fmaf_rn(w, cg[i], prefix[i]) : prefix[i];
        sfx[i] = __fsub_rn(out_dot_g[i], prefix[i]);
      }
      // 2. where a pixel of the warp contributes: the gradient values
      // (straight-line code, zero where this pixel does not contribute)
      // and their sums over the warp
      if (__any_sync(kFull, c)) {
        float v[GV];
#pragma unroll
        for (int r = G0; r < GV; ++r) v[r] = 0.0f;
        const float inv = __fdividef(1.0f, __fsub_rn(1.0f, alpha));   // 1 / (1 - alpha)
        const bool live = c && alpha < kAlphaMax;                     // dalpha = 0 on the cap
        const float wc = c ? w : 0.0f;
        float cg_sum = cg[0], sfx_sum = sfx[0];
#pragma unroll
        for (int i = 1; i < NP; ++i) {
          sfx_sum = __fadd_rn(sfx_sum, sfx[i]);
          cg_sum = __fadd_rn(cg_sum, cg[i]);
        }
#pragma unroll
        for (int ch = 0; ch < 3 * NP; ++ch) v[7 + ch] = __fmul_rn(gc[ch], wc);
        const float gx = -__fmaf_rn(ca, dx, __fmul_rn(cb, dy));   // d power / d mean
        const float gy = -__fmaf_rn(cc, dy, __fmul_rn(cb, dx));
        float dalpha = __fmaf_rn(t_at, cg_sum, -__fmul_rn(__fadd_rn(sfx_sum, gte_ft), inv));
        dalpha = live ? dalpha : 0.0f;
        const float dpower = __fmul_rn(dalpha, alpha);
        const float dmx = __fmul_rn(dpower, gx);
        const float dmy = __fmul_rn(dpower, gy);
        v[0] = dmx;
        v[1] = dmy;
        v[2] = __fmul_rn(dpower, __fmul_rn(__fmul_rn(-0.5f, dx), dx));
        v[3] = __fmul_rn(dpower, __fmul_rn(-dx, dy));
        v[4] = __fmul_rn(dpower, __fmul_rn(__fmul_rn(-0.5f, dy), dy));
        v[5] = __fmul_rn(dalpha, e);
        v[6] = __fmaf_rn(sx, fabsf(dmx), __fmul_rn(sy, fabsf(dmy)));
        if constexpr (PASS_ABS) {
          float ax = 0.0f, ay = 0.0f;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            float da = __fmaf_rn(t_at, cg[i],
                                 -__fmul_rn(__fadd_rn(sfx[i], gte_ft_pass[i]), inv));
            da = live ? da : 0.0f;
            const float dp = __fmul_rn(da, alpha);
            ax = __fadd_rn(ax, fabsf(__fmul_rn(dp, gx)));
            ay = __fadd_rn(ay, fabsf(__fmul_rn(dp, gy)));
          }
          v[G0] = ax;
          v[G0 + 1] = ay;
        }
        reduce_scatter16(v, lane);
#pragma unroll
        for (int r = kFan; r < G; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[r] = __fadd_rn(v[r], __shfl_xor_sync(kFull, v[r], off));
        }
        // lane 2m holds row m's sum
        if (!(lane & 1) && (lane >> 1) < GF) part[warp][lane >> 1][k] = v[0];
        if (lane == 0) {
#pragma unroll
          for (int r = kFan; r < G; ++r) part[warp][r][k] = v[r];
        }
        mine |= 1ull << k;
      }
    }
    if (lane == 0) wrote[warp] = mine;
    // the vote is also the barrier after which `part` is complete and the
    // chunk's entries are no longer read; a warp that wrote no sums for an
    // entry adds zero
    const bool all_done = __syncthreads_count(done) == kPix;
    unsigned long long wr[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wr[w] = wrote[w];
    for (int idx = p; idx < G * n; idx += kPix) {
      const int r = idx / n;
      const int k = idx - r * n;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, (wr[w] >> k & 1ull) ? part[w][r][k] : 0.0f);
      grads[r * grad_stride + start + base + k] = s;
    }
    if (all_done) break;
    if (base + kChunk < count) stage(base + kChunk);
  }
}

template <int NP, bool PASS_ABS>
void launch(const float* table, long long row_stride, const int* starts, const int* counts,
            const int* order, int num_tiles, int grid_x, int tile_base, const float* gcol,
            const float* gte, const float* gte_pass, const float* colors, const float* final_t,
            float sx, float sy, float* grads, long long grad_stride, cudaStream_t s) {
  blend_bwd_kernel<NP, PASS_ABS><<<num_tiles, kPix, 0, s>>>(
      table, row_stride, starts, counts, order, grid_x, num_tiles, tile_base, gcol, gte, gte_pass,
      colors, final_t, sx, sy, grads, grad_stride);
}

using Launch = void (*)(const float*, long long, const int*, const int*, const int*, int, int,
                        int, const float*, const float*, const float*, const float*, const float*,
                        float, float, float*, long long, cudaStream_t);

}  // namespace

extern "C" int wg_blend_bwd(const float* table, long long row_stride,
                            const int* starts, const int* counts, const int* order,
                            int num_tiles, int grid_x, int tile_base, int n_passes,
                            const float* gcol, const float* gte, const float* gte_pass,
                            const float* colors, const float* final_t,
                            float sx, float sy,
                            float* grads, long long grad_stride,
                            void* stream) {
  if (num_tiles <= 0) return 0;
  if (n_passes < 1 || n_passes > 3) return static_cast<int>(cudaErrorInvalidValue);
  static const Launch kLaunch[2][3] = {{launch<1, false>, launch<2, false>, launch<3, false>},
                                       {launch<1, true>, launch<2, true>, launch<3, true>}};
  kLaunch[gte_pass != nullptr][n_passes - 1](table, row_stride, starts, counts, order, num_tiles,
                                             grid_x, tile_base, gcol, gte, gte_pass, colors,
                                             final_t, sx, sy, grads, grad_stride,
                                             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
