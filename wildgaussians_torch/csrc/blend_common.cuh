// What the tile-blend kernels share: the per-(pixel, entry) step of the
// forward recurrence, which K1 (csrc/blend_fwd.cu), K4 (csrc/blend_fwd_planar.cu),
// the probe P1 (csrc/probe_cfin.cu) and the backward K2 (csrc/blend_bwd.cu) all
// take their decisions with; the reach test of an entry against a warp's pixel
// block; and the forward tile walk of K1, K4 and P1.
//
// The recurrence is the TPU kernel `_fwd_kernel`'s
// (wildgaussians_tpu/ops/rasterize_pallas.py:376, its per-chunk math
// `_chunk_fwd_math` :252), in the reference rasterizer's semantics
// (forward.cu). For each pixel, walk its tile's depth-sorted entries in order,
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy        skip if power > 0
//   alpha = min(0.99, op exp(power))                     skip if alpha < 1/255
//   if T (1 - alpha) < 1e-4 the pixel stops; the crossing entry is excluded
//   else the entry contributes with weight w = alpha T; T *= 1 - alpha
// and the tile exits once every pixel has stopped.
//
// The forward walk. One 256-thread block per 16x16 tile, the tiles in the
// caller's order (longest list first, so that the longest serial walks start
// at once and the short ones fill the card around them). Each warp holds an
// 8x4 block of the tile's pixels, one thread per pixel. The tile's entries
// [start, start + count) of the attribute-row table [W, row_stride] are staged
// into shared memory in chunks of 256 by cp.async (entry e of every row by
// thread e: coalesced; kept entry-major for 16-byte reads), into two buffers:
// the next chunk is in flight while the warps walk this one, and one barrier
// a chunk (the block's early-exit vote) both publishes the next chunk and
// frees this one. Each warp tests every entry of the chunk (one per lane,
// 32 at a time) for whether its alpha can reach 1/255 on any of the warp's
// 32 pixels (`reaches`), compacts those that can into a list of the chunk
// (ballot ranks), and walks the list in batches of kBatch whose steps are
// straight-line code: the exps of a batch do not wait on each other's
// transmittance, and only the chunk's last batch carries padding. A warp
// whose pixels have all stopped walks no further; the tile ends after the
// chunk in which every pixel stopped.

#pragma once

#include <cuda_runtime.h>

namespace wg {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
// a warp's pixels: kWarpW x kWarpH of the tile, the warps 2 x 4 of them
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
// entries per staged chunk of the forward walk: one per thread
constexpr int kStage = 256;
// entries of a warp's list whose steps are issued together
constexpr int kBatch = 4;

// The pixel of lane `lane` of warp `warp` within its tile: x, then y.
__device__ __forceinline__ int warp_x0(int warp) { return (warp % (kTile / kWarpW)) * kWarpW; }
__device__ __forceinline__ int warp_y0(int warp) { return (warp / (kTile / kWarpW)) * kWarpH; }
__device__ __forceinline__ int lane_x(int warp, int lane) { return warp_x0(warp) + lane % kWarpW; }
__device__ __forceinline__ int lane_y(int warp, int lane) { return warp_y0(warp) + lane / kWarpW; }
// this thread's pixel, row-major within the tile
__device__ __forceinline__ int tile_pixel() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return lane_y(warp, lane) * kTile + lane_x(warp, lane);
}

// Whether an entry's alpha can reach 1/255 on a warp's pixels, the rows
// [y0, y0 + kWarpH) of the columns [x0, x0 + kWarpW): alpha >= 1/255 needs
// op exp(power) >= 1/255, that is q = d^T C d <= 2 tau with tau =
// log(255 op), C the conic and d = mean - pixel. Along a row q is a
// parabola in dx, convex where ca > 0, whose least value on the row's
// segment is at its clamped minimiser. The bound carries a margin well
// above the rounding of this test and of the per-pixel one. An entry with
// ca <= 0 or a NaN opacity reaches every row (the per-pixel tests decide).
__device__ __forceinline__ bool reaches(float mx, float my, float ca, float cb, float cc,
                                        float op, float x0, float y0) {
  if (!(ca > 0.0f)) return true;
  const float tau = logf(255.0f * op);
  if (!(tau >= 0.0f)) return op != op;
  const float lo = mx - (x0 + (kWarpW - 1)), hi = mx - x0;
  const float slope = -cb / ca;
  bool hit = false;
#pragma unroll
  for (int r = 0; r < kWarpH; ++r) {
    const float dy = my - (y0 + r);
    const float dx = fminf(hi, fmaxf(lo, slope * dy));
    const float q = (ca * dx + 2.0f * cb * dy) * dx + cc * dy * dy;
    const float size = ca * dx * dx + 2.0f * fabsf(cb * dx * dy) + cc * dy * dy;
    hit = hit || q <= 2.002f * tau + 1e-4f * size + 1e-5f;
  }
  return hit;
}

// One (pixel, entry) step of the recurrence.
struct Pair {
  float dx, dy;   // entry mean - pixel
  float e;        // exp(power)
  float alpha;
  float t_at;     // T before the entry
  float w;        // alpha T before the entry
  bool c;         // the entry contributes to the pixel
  bool stop;      // the pixel stops at the entry (the crossing entry)
};

// The step of entry (mx, my, conic ca, cb, cc, opacity op) at pixel (px, py),
// with the pixel's transmittance T and stop flag, which it updates. Each
// operation is rounded on its own (round-to-nearest intrinsics, which the
// compiler neither fuses nor splits), as the plain version's are: every
// kernel that calls it takes the alpha floor and the stop alike, in every
// build. Branch-free: the skips are predicates. A NaN alpha (a NaN opacity)
// stays NaN and is not used, as in the plain version.
__device__ __forceinline__ Pair blend_pair(float mx, float my, float ca, float cb, float cc,
                                           float op, float px, float py, float& T, bool& done) {
  Pair q;
  q.dx = __fsub_rn(mx, px);
  q.dy = __fsub_rn(my, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, q.dx), q.dx),
                               __fmul_rn(__fmul_rn(cc, q.dy), q.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, q.dx), q.dy));
  q.e = expf(power);
  const float a = __fmul_rn(op, q.e);
  q.alpha = a > kAlphaMax ? kAlphaMax : a;
  const bool use = !done && power <= 0.0f && q.alpha >= kAlphaMin;
  const float test_t = __fmul_rn(T, __fsub_rn(1.0f, q.alpha));
  q.stop = use && test_t < kTEps;
  q.c = use && !(test_t < kTEps);
  done = done || q.stop;
  q.t_at = T;
  T = q.c ? test_t : T;
  q.w = __fmul_rn(q.alpha, q.t_at);
  return q;
}

// 4-byte asynchronous copies from device to shared memory (sm_80+).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The forward walk's shared memory: two staged chunks, entry-major, 4-float
// aligned (rows 0-5 x, y, conic a, b, c, opacity, then what the caller reads).
template <int W>
struct WalkSmem {
  static constexpr int kW4 = (W + 3) / 4;
  float4 ent[2][kStage][kW4];
  // each warp's list of the chunk's entries that reach its pixel block
  unsigned char list[kWarps][kStage];
  int last_stop;
};

struct WalkEnd {
  float T;         // the pixel's transmittance after its last contributing entry
  int walked;      // entries the tile needed: up to and including the last
                   // pixel's crossing entry if every pixel stopped, else count
  bool saturated;  // every pixel of the tile stopped (the block's exit vote)
};

// Walks tile t (of a grid grid_x tiles wide) over its entries [start, start +
// count) of `table`; see the header's note. `contrib(q, f)` is called for
// every entry of this thread's warp's lists, with the step q at this thread's
// pixel and the entry's W floats f (padded to 4 kW4), in entry order; it must
// read f only where q.c. Every thread of the block must call it.
template <int W, typename Contrib>
__device__ __forceinline__ WalkEnd walk_tile(const float* __restrict__ table,
                                             long long row_stride, int start, int count, int t,
                                             int grid_x, WalkSmem<W>& sm, Contrib&& contrib) {
  static_assert(kStage == kPix && kStage <= 256 && kBatch == 4,
                "one staged entry per thread; list entries are bytes, read 4 at a time");
  constexpr int kW4 = WalkSmem<W>::kW4;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  // the warp's pixel block, and this thread's pixel in it
  const float x0 = static_cast<float>((t % grid_x) * kTile + warp_x0(warp));
  const float y0 = static_cast<float>((t / grid_x) * kTile + warp_y0(warp));
  const float px = x0 + static_cast<float>(lane % kWarpW);
  const float py = y0 + static_cast<float>(lane / kWarpW);
  const float* src = table + static_cast<long long>(start) + p;

  // stages entries [c, c + kStage) into buffer b: thread p copies entry c + p
  auto stage = [&](int c, int b) {
    if (p < count - c) {
      float* dst = reinterpret_cast<float*>(sm.ent[b][p]);
#pragma unroll
      for (int r = 0; r < W; ++r) cp_async4(dst + r, src + c + r * row_stride);
    }
    cp_async_commit();
  };

  if (p == 0) sm.last_stop = -1;
  float T = 1.0f;
  bool done = false;
  int stop_at = -1;
  bool all_done = false;
  if (count > 0) stage(0, 0);
  cp_async_wait_all();
  __syncthreads();
  // `base`, `count` and `all_done` are uniform over the block, so every
  // thread reaches the same barriers (one per chunk); the tests that skip
  // work are uniform over the warp, so every lane reaches the same votes
  for (int base = 0, b = 0; base < count; base += kStage, b ^= 1) {
    const int n = min(kStage, count - base);
    if (base + kStage < count) stage(base + kStage, b ^ 1);
    const float4(*ent)[kW4] = sm.ent[b];
    unsigned char* list = sm.list[warp];
    int m = 0;
    if (!__all_sync(kFull, done)) {
      // lane l tests entry g + l against the warp's block; the entries that
      // pass go to the list in order
      for (int g = 0; g < n; g += 32) {
        bool r = false;
        if (g + lane < n) {
          const float4 a = ent[g + lane][0];
          const float4 c = ent[g + lane][1];
          r = reaches(a.x, a.y, a.z, a.w, c.x, c.y, x0, y0);
        }
        const unsigned mask = __ballot_sync(kFull, r);
        if (r) list[m + __popc(mask & ((1u << lane) - 1u))] = static_cast<unsigned char>(g + lane);
        m += __popc(mask);
      }
      __syncwarp();
    }
    for (int i = 0; i < m && !__all_sync(kFull, done); i += kBatch) {
      // kBatch list entries at once (the list is 4-byte aligned)
      const unsigned word = *reinterpret_cast<const unsigned*>(list + i);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        // a batch's padding repeats its first entry with opacity 0: alpha 0
        // (or NaN), never used
        const bool real = i + j < m;
        const int k = static_cast<int>((word >> (8 * (real ? j : 0))) & 0xffu);
        float f[4 * kW4];
#pragma unroll
        for (int e = 0; e < kW4; ++e) {
          const float4 v = ent[k][e];
          f[4 * e] = v.x;
          f[4 * e + 1] = v.y;
          f[4 * e + 2] = v.z;
          f[4 * e + 3] = v.w;
        }
        const Pair q = blend_pair(f[0], f[1], f[2], f[3], f[4], real ? f[5] : 0.0f, px, py, T,
                                  done);
        stop_at = q.stop ? base + k : stop_at;
        contrib(q, f);
      }
    }
    cp_async_wait_all();
    all_done = __syncthreads_count(done) == kPix;
    if (all_done) break;
  }

  if (all_done) atomicMax(&sm.last_stop, stop_at);
  __syncthreads();
  return WalkEnd{T, all_done ? sm.last_stop + 1 : count, all_done};
}

}  // namespace wg
