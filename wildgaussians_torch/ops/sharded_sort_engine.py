"""The Gaussian-sharded sort engine: the sort engine under a mesh.

Counterpart of `_make_sharded_sort_blend_vjp` in
`wildgaussians_tpu/ops/rasterize_pallas.py` (exact f32 rows, the JAX
package's `pack16=False` without its f16 gradient rows). Each of the D ranks
owns n / D Gaussians and one band of T_band = ceil(T / D) tiles:

  1. the rank corner-culls, packs and stably sorts the entries of its own
     Gaussians by the single-chip [tile | depth] key
     (`sort_engine._cull_pack_entries` at n / D, a per-shard big-Gaussian
     pool); the entries bound for each band are then one contiguous
     segment, found by `searchsorted` on the band boundaries;
  2. each segment goes into a [D, rows, C] send buffer, C = send_beta
     times the balanced share (128-aligned); the key row is the sentinel
     past each segment, and the entries of a segment beyond C are dropped
     and counted in `send_drops` (summed over the ranks: never silently 0);
     one `all_to_all_single` exchanges the buffers;
  3. the receiver merges its D sorted streams by one stable sort of the
     received keys (the JAX package's bitonic merge, `ops/bitonic.py`,
     compares (key, source position) and so equals this sort for every
     input; its `stream_merge=False` path is this sort), and blends its band
     with K1 at tile base rank * T_band.

The backward runs K2 on the band, routes the entry rows back to receive
order (the merge's permutation), reverses the all-to-all, restores the
sender's sorted order (positions never sent, cap drops and empty slots,
keep zero rows), un-sorts to slot order and reduces on the owning rank
(the cell-major slot sums and K3). Gaussian gradients stay on their rank;
only the background's gradient is summed over the ranks. With unique keys
and no drops, the entry order is the single-chip engine's, so the image
equals the single-device one.
"""
from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import TileMesh, all_reduce_
from ..spans import span
from . import blend
from .rasterize_tiled import TileGrid
from .sort_engine import SortEngineSizes, _cull_pack_entries

_SENTINEL = 0xFFFFFFFF
K_CHUNK = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedSortSizes(NamedTuple):
    n_loc: int       # Gaussians of a rank
    local: SortEngineSizes   # the per-rank pools (d1, d2_extra, m_cap, R_loc, depth_bits)
    T_shpad: int     # tiles padded to D bands
    T_band: int      # tiles of a band
    C: int           # send-buffer entries per (sender, band)


def sharded_sort_sizes(grid: TileGrid, n: int, D: int, d_max: int, d_small: int,
                       big_fraction: float, send_beta: float) -> ShardedSortSizes:
    """The JAX engine's sizes (`rasterize_pallas.py:1816-1850`) for n
    Gaussians over D ranks."""
    if n % D:
        raise ValueError(f"the sharded sort engine needs the Gaussians ({n}) divisible by "
                         f"the ranks ({D})")
    n_loc = n // D
    d1 = min(d_small, d_max)
    d2_extra = d_max - d1
    m_cap = min(max(int(n_loc * big_fraction), 8), n_loc) if d2_extra > 0 else 0
    R_loc = n_loc * d1 + m_cap * d2_extra
    T_shpad = _round_up(grid.num_tiles, D)
    tile_bits = max(int(T_shpad + 1).bit_length(), 1)
    C = min(_round_up(R_loc, 128),
            _round_up(max(int(R_loc * send_beta / D), 2 * K_CHUNK), 128))
    return ShardedSortSizes(n_loc, SortEngineSizes(d1, d2_extra, m_cap, R_loc, 32 - tile_bits),
                            T_shpad, T_shpad // D, C)


def _key_to_i32(key: torch.Tensor) -> torch.Tensor:
    """uint32 keys held in int64 -> their bits as int32."""
    return torch.where(key >= (1 << 31), key - (1 << 32), key).to(torch.int32)


def _i32_to_key(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int64) & _SENTINEL


def segment_positions(seg: torch.Tensor, C: int):
    """[D, C] positions seg[b] + i of the local sorted order that go to band
    b, and whether each is inside its segment."""
    i = torch.arange(C, device=seg.device)
    pos = seg[:-1, None] + i[None, :]
    return pos, pos < seg[1:, None]


class ShardedSortBlend(torch.autograd.Function):
    """The sharded sort-engine blend on this rank's Gaussians (the inputs'
    n is n / D) and band: returns the band's colors with the background
    [n_passes, T_band, 256, 3] and final_T [T_band, 256]; aux gets
    `send_drops` (int64, summed over the ranks), `vis_count` [n / D] and the
    band's `table`, `tile_starts`, `tile_counts`, `walked`. Gradients go to
    this rank's mean2d, conic, opacity, color stack and abs hook (ch0 the
    fused channel, as `_DifferentiableBlend`), and to bg summed over the
    ranks."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors_stack, absgrad_hook, bg,
                depth, rect_min, rect_max, tiles_touched, valid, grid: TileGrid,
                max_tiles_per_gaussian: int, d_small: int, big_fraction: float,
                ndc_scale: Tuple[float, float], mesh: TileMesh, send_beta: float,
                aux: Dict[str, torch.Tensor]):
        del absgrad_hook   # its gradient is the fused abs channel
        D, r = mesh.size, mesh.rank
        n_loc, n_passes = mean2d.shape[0], colors_stack.shape[0]
        sz = sharded_sort_sizes(grid, n_loc * D, D, max_tiles_per_gaussian, d_small,
                                big_fraction, send_beta)
        loc, C, T_band = sz.local, sz.C, sz.T_band
        dev = mean2d.device
        with span("sort_engine"):
            key_all, slot_gaussian, big_list, vis_count = _cull_pack_entries(
                grid, loc, max_tiles_per_gaussian, mean2d, conic, opacity, depth, rect_min,
                rect_max, tiles_touched, valid)
            skey, sflat = torch.sort(key_all, stable=True)
            band_bounds = (torch.arange(D + 1, dtype=torch.int64, device=dev) * T_band
                           ) << loc.depth_bits
            seg = torch.searchsorted(skey, band_bounds, side="left")
            pos, live = segment_positions(seg, C)
            pos_c = torch.clamp_max(pos, loc.R - 1)
            attrs = torch.cat([mean2d.T, conic.T, opacity[None],
                               colors_stack.permute(0, 2, 1).reshape(3 * n_passes, n_loc)])
            W = attrs.shape[0]
            send = torch.empty((D, 1 + W, C), dtype=torch.int32, device=dev)
            send[:, 0] = _key_to_i32(torch.where(live, skey[pos_c], _SENTINEL))
            sent = attrs[:, slot_gaussian[sflat[pos_c]]]                  # [W, D, C]
            send[:, 1:] = torch.where(live[None], sent, 0.0).permute(1, 0, 2).view(torch.int32)
        with span("all_to_all"):
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.group)
            del send
        with span("stream_merge"):
            rkey, route = torch.sort(_i32_to_key(recv[:, 0].reshape(-1)), stable=True)
            t0 = r * T_band
            bounds = (torch.arange(t0, t0 + T_band + 1, dtype=torch.int64, device=dev)
                      << loc.depth_bits)
            starts = torch.searchsorted(rkey, bounds, side="left").to(torch.int32)
            counts = (starts[1:] - starts[:-1]).contiguous()
            n_band = int(starts[-1])
            rows = recv[:, 1:].permute(1, 0, 2).reshape(W, D * C)
            table = rows[:, route[:n_band]].view(torch.float32).contiguous()
            del recv, rows
        with span("blend_kernel"):
            order = blend.tile_order(counts, T_band)
            colors, final_t, walked, _sat = blend.blend_forward(
                table, starts, counts, grid, n_passes, order=order, tile_base=t0,
                num_tiles=T_band)
        # send-cap accounting: the entries past C of every (sender, band)
        # segment were not sent
        send_drops = torch.clamp_min(seg[1:] - seg[:-1] - C, 0).sum()
        all_reduce_(send_drops, mesh)
        ctx.save_for_backward(table, starts, counts, order, colors, final_t, bg, route,
                              seg, sflat, big_list)
        ctx.grid, ctx.ndc_scale, ctx.sz, ctx.mesh = grid, ndc_scale, sz, mesh
        aux.update(table=table, tile_starts=starts, tile_counts=counts, walked=walked,
                   vis_count=vis_count, big_list=big_list, send_drops=send_drops)
        return colors + final_t[..., None] * bg, final_t

    @staticmethod
    def backward(ctx, g_color, g_final_t):
        (table, starts, counts, order, colors, final_t, bg, route, seg, sflat,
         big_list) = ctx.saved_tensors
        sz, mesh = ctx.sz, ctx.mesh
        D, C, loc = mesh.size, sz.C, sz.local
        n_passes = colors.shape[0]
        g_color = g_color.contiguous()
        gte = (g_final_t + torch.einsum("itpc,c->tp", g_color, bg)).contiguous()
        with span("blend_bwd_kernel"):
            eg = blend.blend_backward(table, starts, counts, ctx.grid, n_passes, g_color, gte,
                                      colors, final_t, ctx.ndc_scale, order=order,
                                      tile_base=mesh.rank * sz.T_band, num_tiles=sz.T_band)
        dbg = all_reduce_(torch.einsum("itpc,tp->c", g_color, final_t), mesh)
        G = eg.shape[0]
        with span("unsort"):
            # merged order -> receive order -> back to the senders
            by_recv = torch.zeros((G, D * C), dtype=eg.dtype, device=eg.device)
            by_recv[:, route[:eg.shape[1]]] = eg
            del eg
            send = by_recv.view(G, D, C).permute(1, 0, 2).contiguous()
            back = torch.empty_like(send)
            dist.all_to_all_single(back, send, group=mesh.group)
            del send, by_recv
            # chunk b holds the rows of my sorted positions seg[b] + i, in order
            pos, live = segment_positions(seg, C)
            restored = torch.zeros((G, loc.R), dtype=back.dtype, device=back.device)
            restored[:, pos[live]] = back.permute(1, 0, 2)[:, live]
            by_slot = torch.zeros_like(restored)
            by_slot[:, sflat] = restored
            del restored, back
            sums, bigs = blend.slot_sums(by_slot, loc, sz.n_loc)
        if loc.m_cap > 0:
            with span("tier2_merge"):
                blend.tier2_merge(sums, big_list, bigs)
        dabs = torch.stack([sums[6], torch.zeros_like(sums[6])], dim=-1)
        dcolors = torch.stack([sums[7 + 3 * i:10 + 3 * i].T for i in range(n_passes)])
        return (sums[0:2].T, sums[2:5].T, sums[5], dcolors, dabs, dbg,
                None, None, None, None, None, None, None, None, None, None, None, None, None)
