"""The fused multi-pass tile blend, its backward, and the rasterizer over
the sort engine, the partition engine (ops/partition_engine.py) or the
gather engine (ops/gather_engine.py).

Counterpart of `_make_pallas_blend_vjp` and `rasterize_pallas_multi` in
`wildgaussians_tpu/ops/rasterize_pallas.py` (single chip, sort engine, exact
f32 table: the JAX package's pack16 f16 / rgb10 table, its per-pass color
scale and its f16-pair gradient rows exist only for TPU packing). Three
kernels, each with a plain PyTorch version beside it:

  K1 `blend_forward`   csrc/blend_fwd.cu    the blend of 1-3 color passes
  K2 `blend_backward`  csrc/blend_bwd.cu    per-entry gradient rows
  K3 `tier2_merge`     csrc/tier2_merge.cu  the big-Gaussian slot sums

Each wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an error).
There is no fallback from one to the other. `_DifferentiableBlend` chains
them into the autograd graph.
"""
import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import gather_shards, take_shard
from ..spans import span
from . import _build
from .rasterize_tiled import ALPHA_MAX, ALPHA_MIN, T_EPS, TileGrid, tiles_to_image
from .sort_engine import (SortEngineSizes, _build_sorted_table, _sort_engine_sizes,
                          sat_depth_from_walk)

P_PIX = 256  # 16x16 tile

# elements of one [tiles, 256, entries] intermediate of the plain version;
# tiles are blended in batches that stay under it
_PLAIN_BATCH_ELEMS = 1 << 24


class _PlainBatch(NamedTuple):
    t0: int                 # tiles [t0, t1) of the batch
    t1: int
    ent: torch.Tensor       # [W, B, L] the tiles' entries, padded to the longest
    em: torch.Tensor        # [B, L] a real entry, not padding
    power_ok: torch.Tensor  # [B, P, L] a real entry with power <= 0
    use: torch.Tensor       # [B, P, L] power_ok and alpha >= 1/255
    alpha: torch.Tensor     # [B, P, L]
    lg: torch.Tensor        # [B, P, L] log1p(-alpha) where used, else 0
    t_inc: torch.Tensor     # [B, P, L] T after the entry, exp(inclusive cumsum of lg)
    dx: torch.Tensor        # [B, P, L] entry x - pixel x
    dy: torch.Tensor        # [B, P, L]
    e: torch.Tensor         # [B, P, L] exp(power)


def _plain_batches(table, tile_starts, tile_counts, grid: TileGrid, tile_base: int = 0,
                   num_tiles: Optional[int] = None):
    """K1's per-(pixel, entry) quantities in the JAX kernel's log-space form,
    tile batch by tile batch: each tile's entries [start, start+count) are
    padded to the longest list of the batch, and a batch stays under
    _PLAIN_BATCH_ELEMS elements per intermediate. The num_tiles tiles
    (default: the grid's) lie at grid tiles tile_base, tile_base + 1, ..."""
    if grid.tile_size * grid.tile_size != P_PIX:
        raise ValueError("the blend works on 16x16 tiles")
    dev = table.device
    T = grid.num_tiles if num_tiles is None else num_tiles
    ts = grid.tile_size
    ii = torch.arange(P_PIX, device=dev)
    lx, ly = ii % ts, ii // ts
    counts_host = tile_counts.tolist()
    starts = tile_starts[:T].long()
    counts = tile_counts.long()

    t0 = 0
    while t0 < T:
        t1, longest = t0 + 1, counts_host[t0]
        while t1 < T and (t1 - t0 + 1) * P_PIX * max(longest, counts_host[t1]) <= _PLAIN_BATCH_ELEMS:
            longest = max(longest, counts_host[t1])
            t1 += 1
        if longest > 0:
            tb = torch.arange(t0, t1, device=dev)
            pos = torch.arange(longest, device=dev)
            em = pos[None, :] < counts[t0:t1, None]                     # [B, L]
            idx = torch.where(em, starts[t0:t1, None] + pos[None, :], 0)
            ent = table[:, idx]                                          # [W, B, L]
            tg = tb + tile_base
            px = ((tg % grid.grid_x) * ts)[:, None] + lx[None, :]
            py = ((tg // grid.grid_x) * ts)[:, None] + ly[None, :]
            dx = ent[0][:, None, :] - px.to(torch.float32)[..., None]   # [B, P, L]
            dy = ent[1][:, None, :] - py.to(torch.float32)[..., None]
            ca, cb, cc, op = (ent[r][:, None, :] for r in (2, 3, 4, 5))
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            e = torch.exp(power)
            alpha = torch.clamp_max(op * e, ALPHA_MAX)
            power_ok = em[:, None, :] & (power <= 0.0)
            use = power_ok & (alpha >= ALPHA_MIN)
            lg = torch.where(use, torch.log1p(-torch.where(use, alpha, 0.0)), 0.0)
            t_inc = torch.exp(torch.cumsum(lg, dim=-1))
            yield _PlainBatch(t0, t1, ent, em, power_ok, use, alpha, lg, t_inc, dx, dy, e)
        t0 = t1


def blend_forward_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                        tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                        order: Optional[torch.Tensor] = None, tile_base: int = 0,
                        num_tiles: Optional[int] = None):
    """Plain PyTorch K1, in the JAX kernel's log-space form.

    Per (pixel, entry): use = power <= 0 and alpha >= 1/255; l = log1p(-alpha)
    where used; S = inclusive cumsum of l; T_incl = exp(S); an entry
    contributes alpha * T_incl / (1 - alpha) if used and T_incl >= 1e-4
    (monotone in the entry, so this is the sequential stop). Returns
    (colors [n_passes, T, 256, 3], final_t [T, 256], walked [T] int32,
    saturated [T] int32), as the kernel does. T is num_tiles (default: the
    grid's), the tiles at grid tiles tile_base, tile_base + 1, ... (a band).
    `order` is the kernel's tile order, which changes no result: accepted,
    so that the plain version takes the kernel's arguments, and unused.
    """
    del order
    dev = table.device
    T = grid.num_tiles if num_tiles is None else num_tiles
    colors = torch.zeros((n_passes, T, P_PIX, 3), dtype=torch.float32, device=dev)
    final_t = torch.ones((T, P_PIX), dtype=torch.float32, device=dev)
    walked = torch.zeros((T,), dtype=torch.int32, device=dev)
    saturated = torch.zeros((T,), dtype=torch.int32, device=dev)
    counts = tile_counts.long()
    for b in _plain_batches(table, tile_starts, tile_counts, grid, tile_base, T):
        t0, t1 = b.t0, b.t1
        t_at = b.t_inc * (1.0 / torch.where(b.use, 1.0 - b.alpha, 1.0))
        alive = b.t_inc >= T_EPS
        contrib = b.use & alive
        w = torch.where(contrib, b.alpha * t_at, 0.0)
        for i in range(n_passes):
            col = b.ent[6 + 3 * i:9 + 3 * i]                             # [3, B, L]
            # an f32 matmul; TF32 stays off (torch's default for matmul)
            colors[i, t0:t1] = torch.einsum("bpl,cbl->bpc", w, col)
        final_t[t0:t1] = torch.exp(torch.where(contrib, b.lg, 0.0).sum(-1))
        walked[t0:t1], saturated[t0:t1] = _plain_walked(b, counts)
    return colors, final_t, walked, saturated


def _plain_walked(b: _PlainBatch, counts: torch.Tensor):
    """The entries each tile of the batch needs (K1's `walked`): up to and
    including the last pixel's crossing entry if every pixel stops, else
    all of its entries; and whether every pixel stops (K1's `saturated`),
    both int32 [B]."""
    stop = b.use & ~(b.t_inc >= T_EPS)
    all_stopped = stop.any(-1).all(-1)
    first_stop = torch.argmax(stop.to(torch.uint8), dim=-1)              # [B, P]
    walked = torch.where(all_stopped, first_stop.max(-1).values + 1, counts[b.t0:b.t1])
    return walked.to(torch.int32), all_stopped.to(torch.int32)


def blend_stops_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                      tile_counts: torch.Tensor, grid: TileGrid, final_t: torch.Tensor,
                      tile_base: int = 0, num_tiles: Optional[int] = None):
    """Where another blend of these inputs stopped each pixel, against the
    plain version's stop, from its final_t [T, 256] (K1's): (same [T, 256]
    bool, flip_weight [T, 256] f32).

    Per pixel, with the plain version's log-space T before each entry
    (T_k = exp of the sum of log1p(-alpha) over the used entries before k,
    no stop), the plain version stops at the first used entry whose T
    after it falls under 1e-4 (or after the last entry). The other blend's
    final T is the T before its own stop, so its stop is the used entry
    (or the end) whose T_k lies nearest to it in log space. `same` is
    whether the two stops are one entry; `flip_weight` is the summed
    weight alpha T_k of the used entries between the two stops (0 where
    they agree), the most by which the flip can move the pixel's T and,
    times the largest color, its colors. At alpha's 0.99 cap the stopping
    entry alone can weigh 1e-2: a product and a log-space sum that round T
    differently then part by that much."""
    T = grid.num_tiles if num_tiles is None else num_tiles
    same = torch.ones((T, P_PIX), dtype=torch.bool, device=table.device)
    weight = torch.zeros((T, P_PIX), dtype=torch.float32, device=table.device)
    for b in _plain_batches(table, tile_starts, tile_counts, grid, tile_base, T):
        t0, t1 = b.t0, b.t1
        L = b.lg.shape[-1]
        # S_k, the log T before entry k, k = 0..L (L: after the last)
        s_excl = torch.cat([torch.zeros_like(b.lg[..., :1]), torch.cumsum(b.lg, -1)], -1)
        stop = b.use & ~(b.t_inc >= T_EPS)
        pos = torch.arange(L + 1, device=table.device)
        s_plain = torch.where(stop.any(-1), torch.argmax(stop.to(torch.uint8), -1), L)
        # the other blend's stop: a used entry or the end, nearest in log T
        cand = torch.cat([b.use, torch.ones_like(b.use[..., :1])], -1)
        log_t = torch.log(torch.clamp_min(final_t[t0:t1], 1e-30))[..., None]
        dist = torch.where(cand, (s_excl - log_t).abs(), torch.inf)
        s_other = torch.argmin(dist, -1)
        lo, hi = torch.minimum(s_plain, s_other), torch.maximum(s_plain, s_other)
        w = torch.where(b.use, b.alpha * torch.exp(s_excl[..., :L]), 0.0)
        between = (pos[:L] >= lo[..., None]) & (pos[:L] < hi[..., None])
        same[t0:t1] = s_plain == s_other
        weight[t0:t1] = torch.where(between, w, 0.0).sum(-1)
    return same, weight


def blend_walked_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                       tile_counts: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """K1's `walked` [T] int32 alone, from the same batched walk as
    blend_forward_plain (no colors)."""
    walked = torch.zeros((grid.num_tiles,), dtype=torch.int32, device=table.device)
    counts = tile_counts.long()
    for b in _plain_batches(table, tile_starts, tile_counts, grid):
        walked[b.t0:b.t1] = _plain_walked(b, counts)[0]
    return walked


def blend_pair_counts(table: torch.Tensor, tile_starts: torch.Tensor,
                      tile_counts: torch.Tensor, grid: TileGrid,
                      warp_block: Optional[Tuple[int, int]] = None, tile_base: int = 0,
                      num_tiles: Optional[int] = None) -> Dict[str, int]:
    """The (pixel, entry) pairs K1's function needs on these inputs, by the
    work each needs (from the plain version's masks):

      evaluated    entries up to and including the pixel's own crossing (or
                   all of the tile's): the power and its test;
      exp          evaluated with power <= 0: exp, alpha and its test;
      used         alpha >= 1/255 as well: the T (1 - alpha) test;
      contributing used before the crossing: the weight and each pass's
                   color FMAs.

    With warp_block = (w, h), the tile's pixels are cut into w x h blocks
    (row-major, as K2's warps hold them), and three counts follow for a
    walk that first tests, per (block, entry), whether the entry's alpha
    reaches 1/255 on any pixel of the block, and evaluates the pixels of
    the blocks it reaches only:

      reach_tests        (block, entry) pairs with an evaluated pixel;
      evaluated_reached  evaluated pairs whose block the entry reaches;
      exp_reached        exp pairs whose block the entry reaches.

    tile_base and num_tiles: a band of the grid, as blend_forward's.
    """
    out = dict(evaluated=0, exp=0, used=0, contributing=0)
    if warp_block is not None:
        out.update(reach_tests=0, evaluated_reached=0, exp_reached=0)
        bw, bh = warp_block
        ts = grid.tile_size
    for b in _plain_batches(table, tile_starts, tile_counts, grid, tile_base, num_tiles):
        # T before the entry; T only falls, so T_before >= 1e-4 holds up to
        # and including the pixel's crossing entry
        t_before = torch.cat([torch.ones_like(b.t_inc[..., :1]), b.t_inc[..., :-1]], -1)
        ev = b.em[:, None, :] & (t_before >= T_EPS)
        out["evaluated"] += int(ev.sum())
        out["exp"] += int((ev & b.power_ok).sum())
        out["used"] += int((ev & b.use).sum())
        out["contributing"] += int((b.use & (b.t_inc >= T_EPS)).sum())
        if warp_block is not None:
            nb, _p, L = ev.shape
            blocks = (nb, ts // bh, bh, ts // bw, bw, L)
            reach = b.use.view(blocks).any(4, keepdim=True).any(2, keepdim=True)
            ev_b = ev.view(blocks)
            out["reach_tests"] += int(ev_b.any(4).any(2).sum())
            out["evaluated_reached"] += int((ev_b & reach).sum())
            out["exp_reached"] += int((ev_b & reach & b.power_ok.view(blocks)).sum())
    return out


_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p]


def tile_order(tile_counts: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """The order in which the blend kernels take the tiles: longest list
    first, int32 [num_tiles]."""
    return torch.argsort(tile_counts[:num_tiles], descending=True).to(torch.int32)


def _check_tiles(name, table, tile_starts, tile_counts, order, T):
    """Raise unless the tile arrays (and `order`, if given) are contiguous
    int32 tensors of >= T tiles (order: exactly T) on the table's device."""
    for arg, x in (("tile_starts", tile_starts), ("tile_counts", tile_counts)):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.shape[0] < T or x.device != table.device:
            raise ValueError(f"{name}: {arg} must be a contiguous int32 tensor of >= {T} tiles on "
                             f"{table.device}")
    if order is not None and (order.dtype != torch.int32 or not order.is_contiguous()
                              or tuple(order.shape) != (T,) or order.device != table.device):
        raise ValueError(f"{name}: order must be a contiguous int32 [{T}] on {table.device}")


def _kernel():
    lib = _build.load("blend_fwd")
    fn = lib.wg_blend_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def blend_forward(table: torch.Tensor, tile_starts: torch.Tensor,
                  tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                  order: Optional[torch.Tensor] = None, tile_base: int = 0,
                  num_tiles: Optional[int] = None):
    """K1: blend every tile's depth-sorted entries for 1-3 color passes.

    table [6 + 3 n_passes, N] f32 (rows x, y, conic a/b/c, opacity, then
    r, g, b per pass); tile_starts [T(+1)] and tile_counts [T] int32;
    order [T] int32, the order in which the kernel takes the tiles
    (`tile_order`, computed here when None; it does not change the result).
    Returns (colors [n_passes, T, 256, 3], final_t [T, 256], walked [T],
    saturated [T]): the entries each tile needed and whether all of its
    pixels stopped (int32; see blend_walked_plain and
    `sort_engine.sat_depth_from_walk`). T is num_tiles (default: the grid's):
    with tile_base, the T tiles are grid tiles tile_base, tile_base + 1, ...
    (a shard's band of the grid, blended at its global pixel coordinates).
    A CPU table runs the plain version; a CUDA table launches the kernel and
    adds one to `blend_forward.launches`.
    """
    if table.device.type == "cpu":
        return blend_forward_plain(table, tile_starts, tile_counts, grid, n_passes,
                                   tile_base=tile_base, num_tiles=num_tiles)
    if table.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {table.device}")
    T = grid.num_tiles if num_tiles is None else num_tiles
    if not 1 <= n_passes <= 3:
        raise ValueError(f"blend_forward takes 1-3 color passes, got {n_passes}")
    if grid.tile_size != 16:
        raise ValueError("blend_forward works on 16x16 tiles")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 6 + 3 * n_passes:
        raise ValueError(f"table must be f32 [{6 + 3 * n_passes}, N], got {table.dtype} {tuple(table.shape)}")
    if table.stride(1) != 1:
        raise ValueError("table rows must be contiguous")
    _check_tiles("blend_forward", table, tile_starts, tile_counts, order, T)
    if order is None:
        order = tile_order(tile_counts, T)
    colors = torch.empty((n_passes, T, P_PIX, 3), dtype=torch.float32, device=table.device)
    final_t = torch.empty((T, P_PIX), dtype=torch.float32, device=table.device)
    walked = torch.empty((T,), dtype=torch.int32, device=table.device)
    saturated = torch.empty((T,), dtype=torch.int32, device=table.device)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), tile_starts.data_ptr(),
                 tile_counts.data_ptr(), order.data_ptr(), T, grid.grid_x, int(tile_base),
                 n_passes, colors.data_ptr(), final_t.data_ptr(), walked.data_ptr(),
                 saturated.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {err}")
    blend_forward.launches += 1
    return colors, final_t, walked, saturated


blend_forward.launches = 0


def grad_rows(n_passes: int, pass_abs: bool = False) -> int:
    """Per-entry gradient rows of the blend backward, summed over each
    tile's pixels: rows 0-5 dmx, dmy, dca, dcb, dcc, dop; row 6 the fused
    NDC abs channel; rows 7 + 3i to 9 + 3i the r, g, b of color pass i.
    With `pass_abs`, rows G0 = 7 + 3 n_passes and G0 + 1 follow:
    sum|dmx_pix| and sum|dmy_pix| of each pass's own gradient, each summed
    over the passes. The partition engine, which does not read row 6, puts
    the row G0 + 1 there and sends rows [0, G0 + 1) back through its
    partitions: its abs statistic is then x at row G0, y at row 6."""
    return 7 + 3 * n_passes + (2 if pass_abs else 0)


def blend_backward_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                         tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                         gcol: torch.Tensor, gte: torch.Tensor, colors: torch.Tensor,
                         final_t: torch.Tensor, ndc_scale: Tuple[float, float],
                         gte_pass: Optional[torch.Tensor] = None,
                         order: Optional[torch.Tensor] = None, tile_base: int = 0,
                         num_tiles: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch K2, in the JAX kernel's log-space form (K1's plain
    quantities, `_plain_batches`).

    gcol [n_passes, T, 256, 3] is the color cotangent, gte [T, 256] the
    summed gt_eff (the final_T cotangent plus gcol . bg over the passes),
    colors [n_passes, T, 256, 3] and final_t [T, 256] K1's outputs (colors
    without the background). Per (pixel, entry), where the entry
    contributes: w = alpha T_at; per pass cg = gc . col, prefix = inclusive
    cumsum of w cg, sfx = out . gc - prefix; dalpha = T_at sum(cg) -
    (sum(sfx) + gte final_T) / (1 - alpha), zeroed where alpha is capped.
    Returns [7 + 3 n_passes, N] rows summed over each tile's pixels, zero
    for every entry no pixel reaches. With gte_pass [n_passes, T, 256] (each
    pass's own gt_eff, which sum to gte), 2 rows follow: the sums over the
    passes of sum|dmx_pix| and of sum|dmy_pix| of the dalpha of each pass
    alone (T cg - (sfx + gte_pass final_T) / (1 - alpha)), unscaled. The
    tiles are gcol's T (num_tiles, if given, must be it), at grid tiles
    tile_base, tile_base + 1, ... (as blend_forward_plain's); `order` is
    unused, as there."""
    del order
    if num_tiles is not None and num_tiles != gcol.shape[1]:
        raise ValueError(f"num_tiles {num_tiles} but gcol holds {gcol.shape[1]} tiles")
    sx, sy = float(ndc_scale[0]), float(ndc_scale[1])
    out = torch.zeros((grad_rows(n_passes, gte_pass is not None), table.shape[1]),
                      dtype=torch.float32, device=table.device)
    starts = tile_starts.long()
    for b in _plain_batches(table, tile_starts, tile_counts, grid, tile_base, gcol.shape[1]):
        t0, t1 = b.t0, b.t1
        rinv = 1.0 / torch.where(b.use, 1.0 - b.alpha, 1.0)
        t_at = b.t_inc * rinv
        contrib = b.use & (b.t_inc >= T_EPS)
        w = torch.where(contrib, b.alpha * t_at, 0.0)                   # [B, P, L]
        cg_sum = torch.zeros_like(w)
        sfx_sum = torch.zeros_like(w)
        dcols, pass_terms = [], []
        for i in range(n_passes):
            gc = gcol[i, t0:t1]                                          # [B, P, 3]
            col = b.ent[6 + 3 * i:9 + 3 * i]                             # [3, B, L]
            cg = torch.einsum("bpc,cbl->bpl", gc, col)
            prefix = torch.cumsum(w * cg, dim=-1)
            out_dot_g = (colors[i, t0:t1] * gc).sum(-1)                  # [B, P]
            cg_sum = cg_sum + cg
            sfx_sum = sfx_sum + (out_dot_g[..., None] - prefix)
            dcols.append(torch.einsum("bpc,bpl->cbl", gc, w))
            pass_terms.append((cg, out_dot_g[..., None] - prefix))
        ca, cb, cc = (b.ent[r][:, None, :] for r in (2, 3, 4))

        def pixel_mean_grads(cg, sfx, gte_t):
            """dalpha and the per-pixel mean gradients of one cotangent."""
            gte_ft = (gte_t[t0:t1] * final_t[t0:t1])[..., None]
            dalpha = torch.where(contrib, t_at * cg - (sfx + gte_ft) * rinv, 0.0)
            dalpha = torch.where(b.alpha >= ALPHA_MAX, 0.0, dalpha)
            dpower = dalpha * b.alpha
            return (dalpha, dpower, dpower * (-(ca * b.dx + cb * b.dy)),
                    dpower * (-(cc * b.dy + cb * b.dx)))

        dalpha, dpower, dmx_pix, dmy_pix = pixel_mean_grads(cg_sum, sfx_sum, gte)
        pass_abs = []
        if gte_pass is not None:
            ax = ay = 0.0
            for i, (cg, sfx) in enumerate(pass_terms):
                _da, _dp, mx, my = pixel_mean_grads(cg, sfx, gte_pass[i])
                ax, ay = ax + mx.abs(), ay + my.abs()
            pass_abs = [ax.sum(1), ay.sum(1)]
        rows = torch.stack(
            [dmx_pix.sum(1), dmy_pix.sum(1),
             (dpower * (-0.5 * b.dx * b.dx)).sum(1),
             (dpower * (-b.dx * b.dy)).sum(1),
             (dpower * (-0.5 * b.dy * b.dy)).sum(1),
             (dalpha * b.e).sum(1),
             sx * dmx_pix.abs().sum(1) + sy * dmy_pix.abs().sum(1)]
            + [dc[c] for dc in dcols for c in range(3)] + pass_abs)      # [G, B, L]
        pos = torch.arange(rows.shape[-1], device=table.device)
        idx = starts[t0:t1, None] + pos[None, :]
        out[:, idx[b.em]] = rows[:, b.em]
    return out


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p,
                 ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_void_p]


def _bwd_kernel():
    fn = _build.load("blend_bwd").wg_blend_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_f32(name, x, shape, device):
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) or not x.is_contiguous() \
            or x.device != device:
        raise ValueError(f"{name} must be a contiguous f32 tensor of shape {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def blend_backward(table: torch.Tensor, tile_starts: torch.Tensor,
                   tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                   gcol: torch.Tensor, gte: torch.Tensor, colors: torch.Tensor,
                   final_t: torch.Tensor, ndc_scale: Tuple[float, float],
                   gte_pass: Optional[torch.Tensor] = None,
                   order: Optional[torch.Tensor] = None, tile_base: int = 0,
                   num_tiles: Optional[int] = None) -> torch.Tensor:
    """K2: the per-entry gradient rows [7 + 3 n_passes, N] of the blend, and
    with gte_pass the 2 per-pass abs rows after them (see
    blend_backward_plain for the arguments; `order`, `tile_base` and
    `num_tiles` as blend_forward's). A
    CPU table runs the plain version; a CUDA table launches the kernel in
    `csrc/blend_bwd.cu` and adds one to `blend_backward.launches`."""
    if table.device.type == "cpu":
        return blend_backward_plain(table, tile_starts, tile_counts, grid, n_passes,
                                    gcol, gte, colors, final_t, ndc_scale, gte_pass,
                                    tile_base=tile_base, num_tiles=num_tiles)
    if table.device.type != "cuda":
        raise ValueError(f"blend_backward: unsupported device {table.device}")
    T = grid.num_tiles if num_tiles is None else num_tiles
    if not 1 <= n_passes <= 3:
        raise ValueError(f"blend_backward takes 1-3 color passes, got {n_passes}")
    if grid.tile_size != 16:
        raise ValueError("blend_backward works on 16x16 tiles")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 6 + 3 * n_passes:
        raise ValueError(f"table must be f32 [{6 + 3 * n_passes}, N], got {table.dtype} {tuple(table.shape)}")
    if table.stride(1) != 1:
        raise ValueError("table rows must be contiguous")
    _check_tiles("blend_backward", table, tile_starts, tile_counts, order, T)
    _check_f32("gcol", gcol, (n_passes, T, P_PIX, 3), table.device)
    _check_f32("colors", colors, (n_passes, T, P_PIX, 3), table.device)
    _check_f32("gte", gte, (T, P_PIX), table.device)
    _check_f32("final_t", final_t, (T, P_PIX), table.device)
    if gte_pass is not None:
        _check_f32("gte_pass", gte_pass, (n_passes, T, P_PIX), table.device)
    grads = torch.zeros((grad_rows(n_passes, gte_pass is not None), table.shape[1]),
                        dtype=torch.float32, device=table.device)
    if order is None:
        order = tile_order(tile_counts, T)
    fn = _bwd_kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), tile_starts.data_ptr(),
                 tile_counts.data_ptr(), order.data_ptr(), T, grid.grid_x, int(tile_base),
                 n_passes, gcol.data_ptr(), gte.data_ptr(),
                 None if gte_pass is None else gte_pass.data_ptr(),
                 colors.data_ptr(), final_t.data_ptr(),
                 float(ndc_scale[0]), float(ndc_scale[1]), grads.data_ptr(), grads.stride(0),
                 stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed with CUDA error {err}")
    blend_backward.launches += 1
    return grads


blend_backward.launches = 0


def tier2_merge_plain(sums: torch.Tensor, big_list: torch.Tensor,
                      bigs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: sums[:, big_list[j]] += bigs[:, j] in place, for the
    pool slots whose index is below n = sums.shape[1]; big_list is unique."""
    valid = big_list < sums.shape[1]
    idx = big_list[valid].long()
    sums[:, idx] = sums[:, idx] + bigs[:, valid]
    return sums


_T2_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _t2_kernel():
    fn = _build.load("tier2_merge").wg_tier2_merge
    fn.argtypes = _T2_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def tier2_merge(sums: torch.Tensor, big_list: torch.Tensor, bigs: torch.Tensor) -> torch.Tensor:
    """K3: merge the tier-2 slot sums bigs [rows, m_cap] into the per-Gaussian
    sums [rows, n] in place at the sorted, unique big_list [m_cap] (entries
    >= n are padding). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel in `csrc/tier2_merge.cu` (unless the pool is empty)
    and adds one to `tier2_merge.launches`. Returns sums."""
    if sums.device.type == "cpu":
        return tier2_merge_plain(sums, big_list, bigs)
    if sums.device.type != "cuda":
        raise ValueError(f"tier2_merge: unsupported device {sums.device}")
    rows, n = sums.shape
    m = big_list.shape[0]
    if sums.dtype != torch.float32 or sums.stride(1) != 1:
        raise ValueError("sums must be f32 with contiguous rows")
    if bigs.dtype != torch.float32 or tuple(bigs.shape) != (rows, m) \
            or (m > 0 and bigs.stride(1) != 1) or bigs.device != sums.device:
        raise ValueError(f"bigs must be f32 [{rows}, {m}] with contiguous rows on {sums.device}")
    if big_list.dtype != torch.int32 or not big_list.is_contiguous() or big_list.device != sums.device:
        raise ValueError(f"big_list must be a contiguous int32 tensor on {sums.device}")
    if m == 0 or rows == 0:
        return sums     # an empty pool: nothing to merge, no launch
    fn = _t2_kernel()
    with torch.cuda.device(sums.device):
        stream = torch.cuda.current_stream(sums.device).cuda_stream
        err = fn(sums.data_ptr(), sums.stride(0), n, bigs.data_ptr(), bigs.stride(0),
                 big_list.data_ptr(), m, rows, stream)
    if err != 0:
        raise RuntimeError(f"tier2_merge kernel launch failed with CUDA error {err}")
    tier2_merge.launches += 1
    return sums


tier2_merge.launches = 0


def slot_sums(rows_by_slot: torch.Tensor, sizes: SortEngineSizes, n: int):
    """Cell-major slot sums (the JAX package's `slot_base` / `slot_big`):
    per Gaussian, the sum of its d1 tier-1 slots [rows, n], and per big-pool
    slot the sum of its d2_extra tier-2 slots [rows, m_cap], each summed
    left to right."""
    sums = rows_by_slot[:, 0:n]
    for j in range(1, sizes.d1):
        sums = sums + rows_by_slot[:, j * n:(j + 1) * n]
    slots1, m_cap = n * sizes.d1, sizes.m_cap
    bigs = rows_by_slot[:, slots1:slots1 + m_cap]
    for j2 in range(1, sizes.d2_extra):
        bigs = bigs + rows_by_slot[:, slots1 + j2 * m_cap:slots1 + (j2 + 1) * m_cap]
    return sums.contiguous(), bigs.contiguous()


class _DifferentiableBlend(torch.autograd.Function):
    """The sort-engine blend with its backward: the counterpart of
    `_make_pallas_blend_vjp` (single chip, exact f32 table).

    Forward: the sort engine and K1 for 1-3 passes; returns the colors with
    the background [n_passes, T, 256, 3] and final_T [T, 256] (shared by
    the passes), and puts each tile's saturation depth (`sat_depth_from_walk`)
    in aux["sat_depth"]. `sat_super` [sy, sx] (or None) is the saturation
    map the binning culls under. Backward: the cotangent pack, K2, dbg, the
    un-sort of the per-entry rows to slot order, the cell-major slot sums
    and K3. Gradients go to mean2d, conic, opacity, the color stack, the
    abs-gradient hook ([N, 2]: ch0 = sx sum|dmx_pix| + sy sum|dmy_pix|, ch1
    = 0) and bg."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors_stack, absgrad_hook, bg,
                depth, rect_min, rect_max, tiles_touched, valid, grid: TileGrid,
                max_tiles_per_gaussian: int, d_small: int, big_fraction: float,
                ndc_scale: Tuple[float, float], sat_super: Optional[torch.Tensor],
                aux: Dict[str, torch.Tensor]):
        del absgrad_hook   # its gradient is the fused abs channel
        n, n_passes = mean2d.shape[0], colors_stack.shape[0]
        with span("sort_engine"):
            st = _build_sorted_table(
                grid, n, max_tiles_per_gaussian, n_passes, d_small, big_fraction,
                mean2d, conic, opacity, colors_stack, depth, rect_min, rect_max,
                tiles_touched, valid, sat_super)
        with span("blend_kernel"):
            # K1 and K2 take the tiles in one order, computed once a step
            order = tile_order(st.tile_counts, grid.num_tiles)
            colors, final_t, walked, saturated = blend_forward(
                st.table, st.tile_starts, st.tile_counts, grid, n_passes, order=order)
        sizes = _sort_engine_sizes(grid, n, max_tiles_per_gaussian, d_small, big_fraction)
        with span("sat_depth"):
            sat_depth = sat_depth_from_walk(walked, saturated, st.tile_starts, st.tile_counts,
                                            st.sorted_key, sizes.depth_bits)
        ctx.save_for_backward(st.table, st.sorted_flat, st.tile_starts, st.tile_counts,
                              st.big_list, colors, final_t, bg, order)
        ctx.grid, ctx.ndc_scale, ctx.n, ctx.sizes = grid, ndc_scale, n, sizes
        aux.update(table=st.table, tile_starts=st.tile_starts, tile_counts=st.tile_counts,
                   walked=walked, saturated=saturated, sat_depth=sat_depth,
                   vis_count=st.vis_count, big_list=st.big_list, sorted_flat=st.sorted_flat,
                   sorted_key=st.sorted_key)
        return colors + final_t[..., None] * bg, final_t

    @staticmethod
    def backward(ctx, g_color, g_final_t):
        table, sorted_flat, tile_starts, tile_counts, big_list, colors, final_t, bg, order = \
            ctx.saved_tensors
        n_passes = colors.shape[0]
        sizes = ctx.sizes
        n = ctx.n
        g_color = g_color.contiguous()
        # cotangent pack: gt_eff summed over the passes (final_T is shared)
        gte = (g_final_t + torch.einsum("itpc,c->tp", g_color, bg)).contiguous()
        with span("blend_bwd_kernel"):
            eg = blend_backward(table, tile_starts, tile_counts, ctx.grid, n_passes,
                                g_color, gte, colors, final_t, ctx.ndc_scale, order=order)
        dbg = torch.einsum("itpc,tp->c", g_color, final_t)
        with span("unsort"):
            # the sort engine's order is a permutation of the slots; slots
            # past the binned entries (empty cells) get zero rows
            by_slot = torch.zeros((eg.shape[0], sizes.R), dtype=eg.dtype, device=eg.device)
            by_slot[:, sorted_flat[:eg.shape[1]].long()] = eg
            sums, bigs = slot_sums(by_slot, sizes, n)
        if sizes.m_cap > 0:
            with span("tier2_merge"):
                tier2_merge(sums, big_list, bigs)
        dabs = torch.stack([sums[6], torch.zeros_like(sums[6])], dim=-1)
        dcolors = torch.stack([sums[7 + 3 * i:10 + 3 * i].T for i in range(n_passes)])
        return (sums[0:2].T, sums[2:5].T, sums[5], dcolors, dabs, dbg,
                None, None, None, None, None, None, None, None, None, None, None, None)


def check_binning(binning: str):
    """Raise unless `binning` (the config's `pallas_binning`) names an
    engine: 'sort', 'partition' or 'gather'."""
    if binning not in ("sort", "partition", "gather"):
        raise ValueError(f"unknown pallas_binning {binning!r}: 'sort', 'partition' or 'gather'")


def engine_binning(binning: str, mesh=None) -> str:
    """The engine `rasterize_multi` runs for `binning`: under a mesh,
    "gather" (which has no sharded path) runs as "sort"."""
    check_binning(binning)
    return "sort" if mesh is not None and binning == "gather" else binning


def rasterize_multi(mean2d, conic, opacity, colors_list: List[torch.Tensor],
                    pre_depth, pre_rect_min, pre_rect_max, pre_tiles_touched,
                    pre_valid, bg, *, grid: TileGrid,
                    max_tiles_per_gaussian: int = 16, d_small: int = 4,
                    big_fraction: float = 0.16, binning: str = "sort",
                    absgrad_hook: Optional[torch.Tensor] = None,
                    ndc_scale: Tuple[float, float] = (1.0, 1.0),
                    sat_super: Optional[torch.Tensor] = None,
                    mesh=None, send_beta: float = 2.0, grads_sharded: bool = False
                    ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Render several color sets over one shared binned geometry.

    binning: "sort" (the sort engine, `_DifferentiableBlend`), "partition"
    (the radix partition engine, `partition_engine.PartitionBlend`) or
    "gather" (`gather_engine.GatherBlend`); the last two bin raw rect cells
    with d_small floored at 6 (`engine_d_small`).

    sat_super [sy, sx] (the sort engine only): the saturation map
    (`sort_engine.pool_sat_depth`) under which the binning culls cells that
    lie at or beyond their supertile's depth; None culls nothing, and a map
    of +inf gives the same table.

    Returns ([(color [H,W,3], final_T [H,W]) per color set], aux): aux
    holds the blend's inputs (`table`, `tile_starts`, `tile_counts`), its
    per-tile `walked` counts and `big_list`; the sort engine adds K1's
    per-tile `saturated` votes, each tile's saturation depth `sat_depth`
    [T] (+inf where it did not saturate), its per-Gaussian `vis_count`, slot
    order `sorted_flat` and sorted keys `sorted_key`; the partition engine its whole `entry_table`
    (key rows first) and the `presort_meta`, `rank_meta` (None without tier
    2) and `tile_meta` of its partitions; the gather engine each entry's
    Gaussian `gid`. The sort engine's final_T image is one tensor shared by
    the passes; the other engines give each pass its own (equal values).

    Differentiable (K2 and K3 in the backward; K6 too for "partition"; K2
    alone for "gather") wherever grad is enabled; `absgrad_hook` [N, 2]
    (zeros) then receives the abs-gradient channels scaled by `ndc_scale` =
    (0.5 W, 0.5 H): the sort engine's fused one in ch0 (sx sum|dmx| + sy
    sum|dmy| of the summed gradient, ch1 = 0), the other engines' per-axis
    ones summed over the passes (ch0 = sum over passes of sx sum|dmx|, ch1
    of sy sum|dmy|). Under `no_grad` nothing is kept for a backward.

    Under a mesh (`parallel.mesh.TileMesh`, the JAX package's dispatch at
    rasterize_pallas.py:2801-2822): "gather" has no sharded path and runs
    as "sort" (`engine_binning`); "sort" runs the Gaussian-sharded sort
    engine (`sharded_sort_engine.ShardedSortBlend`, `send_beta`), which
    needs the Gaussians divisible by the ranks; "partition" the
    tile-sharded partition path. With `grads_sharded` (the trainer's
    `shard_gaussian_store`) the per-Gaussian inputs are this rank's block
    of n * D Gaussians and their gradients stay this rank's; otherwise they
    are every Gaussian, on every rank, and so are their gradients. The
    images are whole on every rank (each rank's band gathered), and aux
    holds `send_drops`, the entries the send cap dropped over the ranks (0
    for "partition"), and the rank's own band of the blend's inputs."""
    check_binning(binning)
    if sat_super is not None and binning != "sort":
        raise ValueError(f"saturation culling runs on the sort engine only, not {binning!r}")
    if absgrad_hook is None:
        absgrad_hook = torch.zeros((mean2d.shape[0], 2), dtype=torch.float32,
                                   device=mean2d.device)
    if mesh is not None:
        return _rasterize_on_mesh(
            mean2d, conic, opacity, colors_list, pre_depth, pre_rect_min, pre_rect_max,
            pre_tiles_touched, pre_valid, bg, grid, max_tiles_per_gaussian, d_small,
            big_fraction, binning, absgrad_hook, ndc_scale, sat_super, mesh, send_beta,
            grads_sharded)
    aux: Dict[str, torch.Tensor] = {}
    args = (mean2d, conic, opacity, torch.stack(colors_list), absgrad_hook, bg,
            pre_depth, pre_rect_min, pre_rect_max,
            torch.clamp_max(pre_tiles_touched, max_tiles_per_gaussian), pre_valid, grid,
            max_tiles_per_gaussian)
    if binning == "sort":
        color, final_t = _DifferentiableBlend.apply(*args, d_small, big_fraction, ndc_scale,
                                                    sat_super, aux)
    else:
        # they import this module
        from .gather_engine import GatherBlend
        from .partition_engine import PartitionBlend, engine_d_small
        fn = PartitionBlend if binning == "partition" else GatherBlend
        color, final_t = fn.apply(*args, engine_d_small(d_small), big_fraction, ndc_scale, aux)
    return _compose(color, final_t, grid), aux


def _compose(color, final_t, grid: TileGrid):
    """[(color [H,W,3], final_T [H,W]) per pass] from the tiles' colors
    [n_passes, T, 256, 3] and final_T ([T, 256] shared by the passes, or
    one [n_passes, T, 256] per pass: the partition and gather engines)."""
    with span("compose"):
        if final_t.dim() == 3:
            return [(tiles_to_image(color[i], grid), tiles_to_image(final_t[i], grid))
                    for i in range(color.shape[0])]
        T_img = tiles_to_image(final_t, grid)
        return [(tiles_to_image(color[i], grid), T_img) for i in range(color.shape[0])]


def _rasterize_on_mesh(mean2d, conic, opacity, colors_list, pre_depth, pre_rect_min,
                       pre_rect_max, pre_tiles_touched, pre_valid, bg, grid, max_tiles_per_gaussian,
                       d_small, big_fraction, binning, absgrad_hook, ndc_scale, sat_super, mesh,
                       send_beta, grads_sharded):
    """rasterize_multi under a mesh (see there)."""
    # they import this module
    from .partition_engine import PartitionBlend, engine_d_small
    from .sharded_sort_engine import ShardedSortBlend
    if sat_super is not None:
        raise ValueError("saturation culling runs on one device only (the JAX trainer's "
                         "_use_satcull)")
    binning = engine_binning(binning, mesh)
    D = mesh.size
    n = mean2d.shape[0] * (D if grads_sharded else 1)
    if binning == "sort" and n % D:
        raise ValueError(f"the sharded sort engine needs n ({n}) divisible by the mesh "
                         f"({D}): pad the Gaussian capacity")
    stack = torch.stack(colors_list)
    per_gaussian = [mean2d, conic, opacity, stack, absgrad_hook, pre_depth, pre_rect_min,
                    pre_rect_max, torch.clamp_max(pre_tiles_touched, max_tiles_per_gaussian),
                    pre_valid]
    dims = [0, 0, 0, 1, 0, 0, 0, 0, 0, 0]
    # the sort engine bins a rank's own Gaussians, the partition engine
    # every Gaussian
    if binning == "sort" and not grads_sharded:
        per_gaussian = [take_shard(x, mesh, d) for x, d in zip(per_gaussian, dims)]
    elif binning == "partition" and grads_sharded:
        per_gaussian = [gather_shards(x, mesh, d) for x, d in zip(per_gaussian, dims)]
    m2d, con, op, st, hook, dep, rmin, rmax, tt, val = per_gaussian
    aux: Dict[str, torch.Tensor] = {}
    head = (m2d, con, op, st, hook, bg, dep, rmin, rmax, tt, val, grid, max_tiles_per_gaussian)
    if binning == "sort":
        color, final_t = ShardedSortBlend.apply(*head, d_small, big_fraction, ndc_scale, mesh,
                                                float(send_beta), aux)
    else:
        color, final_t = PartitionBlend.apply(*head, engine_d_small(d_small), big_fraction,
                                              ndc_scale, aux, mesh)
        aux["send_drops"] = torch.zeros((), dtype=torch.int64, device=mean2d.device)
    T = grid.num_tiles
    with span("gather_bands"):
        color = gather_shards(color, mesh, 1)[:, :T]
        final_t = gather_shards(final_t, mesh, final_t.dim() - 2)[..., :T, :]
    return _compose(color, final_t, grid), aux


def rasterize_pallas(mean2d, conic, opacity, colors, absgrad_hook, pre_depth, pre_rect_min,
                     pre_rect_max, pre_tiles_touched, pre_valid, bg, *, grid: TileGrid,
                     chunk: int = 256, max_tiles_per_gaussian: int = 16, d_small: int = 4,
                     big_fraction: float = 0.16, binning: str = "sort", pack16: bool = True,
                     ndc_scale: Optional[Tuple[float, float]] = None):
    """Single-pass wrapper around rasterize_multi (the JAX package's
    `rasterize_pallas`): returns (color [H,W,3], final_T [H,W]). `chunk`
    must be the kernels' 256; `pack16` is accepted and has no effect (the
    port's tables are always f32, the JAX package's `pack16=False`);
    `ndc_scale` defaults to (1, 1)."""
    if chunk != 256:
        raise ValueError(f"the blend kernels walk 256-entry chunks, got chunk={chunk}")
    del pack16
    (out,), _aux = rasterize_multi(
        mean2d, conic, opacity, [colors], pre_depth, pre_rect_min, pre_rect_max,
        pre_tiles_touched, pre_valid, bg, grid=grid,
        max_tiles_per_gaussian=max_tiles_per_gaussian, d_small=d_small,
        big_fraction=big_fraction, binning=binning, absgrad_hook=absgrad_hook,
        ndc_scale=(1.0, 1.0) if ndc_scale is None else tuple(float(x) for x in ndc_scale))
    return out
