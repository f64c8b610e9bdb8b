"""The gather engine: the blend's binning by one key sort that carries only
the slot index, the entry table by one row gather, and the backward's
per-Gaussian sums by one scatter-add.

Counterpart of `_make_gather_blend_vjp` in
`wildgaussians_tpu/ops/rasterize_pallas.py` (:2567-2740, single chip), the
engine of `pallas_binning: gather`. Unlike the sort engine it bins raw rect
cells, with no corner cull:

  1. slots are GAUSSIAN-MAJOR: tier-1 slot g * d1 + j for the first d1 rect
     cells of every Gaussian, then tier-2 slot n d1 + b d2_extra + j2 for
     rect cells [d1, d_max) of the first m_cap Gaussians with more than d1
     rect cells (`big_list`, ascending, padded with n);
  2. the key is the sort engine's (`sort_engine._quantized_key`), and so
     are the slot counts (`_sort_engine_sizes` with the engine's d_small);
     one stable sort by key gives the slot order (the JAX package's
     `lax.sort` on (key, slot));
  3. each sorted slot maps to its Gaussian id (`gid`, n for an empty
     tier-2 slot), and one gather of the attribute matrix [6 + 3 np, n + 1],
     whose last column is zero, builds the table of the binned entries;
  4. K1 blends it. The JAX engine launches K1 once per pass; the passes
     share alpha and T, so one fused launch computes the same.

The backward runs K2 with its two per-pass abs rows (the JAX engine's K2
rows 9:11 summed over its one launch per pass) and sums every entry's rows
into its Gaussian with one `index_add_` by `gid` (plain XLA in the JAX
package too). The abs-gradient hook receives the per-axis channels scaled
by ndc_scale, as the partition engine's. No K3: there is no slot-sum
matrix to merge.
"""
from typing import Dict, NamedTuple, Tuple

import torch

from ..spans import span
from . import blend
from .rasterize_tiled import TileGrid
from .sort_engine import SortEngineSizes, _quantized_key, _sort_engine_sizes, _tile_of_cell


def _keys(rmin, rw, tt, vald, depth, cells: torch.Tensor, grid: TileGrid,
          depth_bits: int) -> torch.Tensor:
    """Sort keys [m * c] of the rect cells `cells` [c] of m Gaussians, in
    Gaussian-major order; 0xFFFFFFFF past a Gaussian's rect or for an
    invalid one."""
    tile = _tile_of_cell(rmin, rw, cells[:, None], grid.grid_x).T           # [m, c]
    dup = (cells[None] < tt[:, None]) & vald[:, None]
    return _quantized_key(tile, depth[:, None], dup, depth_bits).reshape(-1)


class GatherTable(NamedTuple):
    table: torch.Tensor        # [6 + 3 np, N] f32, N = tile_starts[-1] binned entries
    gid: torch.Tensor          # [N] int64 Gaussian of each binned entry
    tile_starts: torch.Tensor  # [T+1] int32
    tile_counts: torch.Tensor  # [T] int32
    big_list: torch.Tensor     # [m_cap] int32
    sizes: SortEngineSizes


def build_gather_table(grid: TileGrid, n: int, d_max: int, n_passes: int, d_small: int,
                       big_fraction: float, mean2d, conic, opacity, colors_stack, depth,
                       rect_min, rect_max, tiles_touched, valid) -> GatherTable:
    """Keys, one stable sort, Gaussian ids and the gathered entry table
    (rows x, y, conic a, b, c, opacity, then r, g, b per pass); `d_small`
    is the engine's own (the caller floors it at 6, as for the partition
    engine)."""
    sz = _sort_engine_sizes(grid, n, d_max, d_small, big_fraction)
    dev = valid.device
    rect_w = torch.clamp_min(rect_max[:, 0] - rect_min[:, 0], 1)
    keys = [_keys(rect_min, rect_w, tiles_touched, valid, depth,
                  torch.arange(sz.d1, dtype=torch.int32, device=dev), grid, sz.depth_bits)]
    if sz.m_cap > 0:
        first = torch.nonzero((tiles_touched > sz.d1) & valid).flatten()[:sz.m_cap]
        big_list = torch.cat([first.to(torch.int32),
                              torch.full((sz.m_cap - first.shape[0],), n, dtype=torch.int32,
                                         device=dev)])
        bl = torch.clamp_max(big_list, n - 1).long()
        cells2 = torch.arange(sz.d1, d_max, dtype=torch.int32, device=dev)
        keys.append(_keys(rect_min[bl], rect_w[bl], tiles_touched[bl], big_list < n, depth[bl],
                          cells2, grid, sz.depth_bits))
    else:
        big_list = torch.zeros((0,), dtype=torch.int32, device=dev)
    with span("gather_sort"):
        sorted_key, sorted_flat = torch.sort(torch.cat(keys), stable=True)
    bounds = (torch.arange(grid.num_tiles + 1, dtype=torch.int64, device=dev)
              << sz.depth_bits)
    tile_starts = torch.searchsorted(sorted_key, bounds, side="left").to(torch.int32)
    tile_counts = tile_starts[1:] - tile_starts[:-1]
    flat = sorted_flat[:int(tile_starts[-1])]
    slots1 = n * sz.d1
    gid = flat // sz.d1
    if sz.m_cap > 0:
        t2row = torch.clamp((flat - slots1) // sz.d2_extra, 0, sz.m_cap - 1)
        gid = torch.where(flat < slots1, gid, big_list[t2row].long())
    gid = torch.clamp_max(gid, n)          # an empty slot reads the zero column
    with span("gather_table"):
        attrs = torch.cat([mean2d.T, conic.T, opacity[None],
                           colors_stack.permute(0, 2, 1).reshape(3 * n_passes, n)])
        attrs = torch.cat([attrs, torch.zeros_like(attrs[:, :1])], dim=1)
        table = attrs[:, gid].contiguous()
    return GatherTable(table, gid, tile_starts, tile_counts, big_list, sz)


class GatherBlend(torch.autograd.Function):
    """The gather-engine blend with its backward: the counterpart of
    `_make_gather_blend_vjp` (single chip). Returns the colors with the
    background [n_passes, T, 256, 3] and each pass's final_T [n_passes, T,
    256] (equal values; each pass's own cotangent reaches the backward, as
    in the JAX engine). The abs-gradient hook [N, 2] receives ch0 = sum
    over passes of sx sum|dmx_pix| of that pass's gradient alone, ch1 the
    same of sy sum|dmy_pix|."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors_stack, absgrad_hook, bg, depth, rect_min,
                rect_max, tiles_touched, valid, grid: TileGrid, max_tiles_per_gaussian: int,
                d_small: int, big_fraction: float, ndc_scale: Tuple[float, float],
                aux: Dict[str, torch.Tensor]):
        del absgrad_hook   # its gradient is the per-axis abs channels
        n, n_passes = mean2d.shape[0], colors_stack.shape[0]
        with span("gather_engine"):
            gt = build_gather_table(grid, n, max_tiles_per_gaussian, n_passes, d_small,
                                    big_fraction, mean2d, conic, opacity, colors_stack, depth,
                                    rect_min, rect_max, tiles_touched, valid)
        with span("blend_kernel"):
            # K1 and K2 take the tiles in one order, computed once a step
            order = blend.tile_order(gt.tile_counts, grid.num_tiles)
            colors, final_t, walked, _sat = blend.blend_forward(
                gt.table, gt.tile_starts, gt.tile_counts, grid, n_passes, order=order)
        ctx.save_for_backward(gt.table, gt.gid, gt.tile_starts, gt.tile_counts, colors,
                              final_t, bg, order)
        ctx.grid, ctx.ndc_scale, ctx.n = grid, ndc_scale, n
        aux.update(table=gt.table, tile_starts=gt.tile_starts, tile_counts=gt.tile_counts,
                   walked=walked, big_list=gt.big_list, gid=gt.gid)
        return colors + final_t[..., None] * bg, final_t.repeat(n_passes, 1, 1)

    @staticmethod
    def backward(ctx, g_color, g_final_t):
        table, gid, starts, counts, colors, final_t, bg, order = ctx.saved_tensors
        n = ctx.n
        n_passes = colors.shape[0]
        G0 = blend.grad_rows(n_passes)
        g_color = g_color.contiguous()
        # cotangent pack: each pass's gt_eff, and their sum (final_T is shared)
        gte_pass = (g_final_t + torch.einsum("itpc,c->itp", g_color, bg)).contiguous()
        gte = gte_pass.sum(0)
        with span("blend_bwd_kernel"):
            eg = blend.blend_backward(table, starts, counts, ctx.grid, n_passes, g_color, gte,
                                      colors, final_t, ctx.ndc_scale, gte_pass, order=order)
        dbg = torch.einsum("itpc,tp->c", g_color, final_t)
        with span("gather_scatter"):
            # every binned entry's rows into its Gaussian (column n: empty slots)
            acc = torch.zeros((eg.shape[0], n + 1), dtype=eg.dtype, device=eg.device)
            acc.index_add_(1, gid, eg)
            acc = acc[:, :n]
        sx, sy = ctx.ndc_scale
        dabs = torch.stack([acc[G0] * float(sx), acc[G0 + 1] * float(sy)], dim=-1)
        dcolors = torch.stack([acc[7 + 3 * i:10 + 3 * i].T for i in range(n_passes)])
        return (acc[0:2].T, acc[2:5].T, acc[5], dcolors, dabs, dbg,
                None, None, None, None, None, None, None, None, None, None, None)
