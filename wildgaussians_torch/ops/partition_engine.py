"""The partition engine: the blend's binning by stable radix partitions, and
its backward by their inverses.

Counterpart of `_make_partition_blend_vjp` in
`wildgaussians_tpu/ops/rasterize_pallas.py` (:2161-2563, single chip), the
engine of `pallas_binning: partition`. Where the sort engine culls, compacts
and sorts, this one:

  1. presorts the Gaussians once by 24-bit depth keys (positive-f32 depth
     bits >> 8) with a radix partition of a per-Gaussian table, so that
     rank order is depth order (the rank space holds the presort's holes);
  2. duplicates each rank into its raw rect cells in rank-major slots: d1
     cheap slots per rank, then d2_extra more for each of the first m_cap
     big Gaussians (`big_list`);
  3. when tier 2 exists, merges the two rank-sorted tiers into one
     rank-major stream by a partition on the rank (key row 0), then
     partitions by tile (key row 1, tiles shifted by one so that empty slots
     and the rank passes' holes pool in a dead bucket 0); without tier 2 the
     tile partition alone (key row 0). Each tile's segment is then in depth
     order;
  4. blends the tile segments with K1 over the table's attribute rows.

The backward runs K2 on the same rows (with its two per-pass abs rows), sends
the per-entry rows back through the inverse tile and rank partitions (K6),
sums them per rank (tier 1 over d1 slots, tier 2 per pool slot merged at
`big_list` by K3), and sends the rank sums back through the inverse
presort.

The radix passes are K5 and K6 (ops/partition.py). The tables are f32
throughout: the JAX engine's K2 rows are plain f32 here as well
(`grad_packed=False`), and its rows padded to multiples of 8 are TPU layout
that the port leaves out.
"""
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..parallel.mesh import TileMesh, all_reduce_
from ..spans import span
from . import blend
from .partition import PartitionMeta, bucket_ranges, num_passes, radix_partition, \
    radix_unpartition
from .rasterize_tiled import TileGrid

PRESORT_NB = (1 << 24) - 1   # depth keyspace: positive-f32 bit patterns >> 8
E = 256
B = 16
K_CHUNK = 256                # the JAX blend's entry chunk; sets the tail margin


def engine_d_small(d_small: int) -> int:
    """The engine's cheap slots per Gaussian: it bins raw rect cells (no
    corner cull), so the config's `pallas_d_small`, calibrated on the sort
    engine's visible cells, floors at 6 (`rasterize_pallas_multi`)."""
    return max(d_small, 6)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PartitionEngineSizes(NamedTuple):
    n_pad: int       # Gaussians padded to E
    L1: int          # presort passes
    n1: int          # rank space, with the presort's holes
    d1: int          # cheap slots of every rank
    d2_extra: int    # deep slots of a big Gaussian
    m_cap: int       # big-Gaussian pool (0: no tier 2)
    slots1: int
    slots2: int
    R0: int          # slot table width
    L_A: int         # rank-merge passes (0 without tier 2)
    R_A: int         # width after the rank merge
    tile_nb: int     # tile buckets (+1 dead bucket with tier 2)
    L2: int          # tile passes
    TAIL: int        # sentinel margin after the last tile pass
    R_L: int         # final entry-table width
    nkey: int        # leading key rows of the entry table


def partition_engine_sizes(grid: TileGrid, n: int, d_max: int, d_small: int,
                           big_fraction: float) -> PartitionEngineSizes:
    """The engine's static sizes, as `_make_partition_blend_vjp` computes
    them (rasterize_pallas.py:2195-2226); d_small is the engine's own
    (engine_d_small)."""
    d1 = min(d_small, d_max)
    d2_extra = d_max - d1
    m_cap = min(max(int(n * big_fraction), 8), n) if d2_extra > 0 else 0
    tiered = m_cap > 0
    n_pad = _round_up(n, E)
    L1 = num_passes(PRESORT_NB, B)
    n1 = n_pad + L1 * B * E
    slots1 = n1 * d1
    slots2 = m_cap * d2_extra
    R0 = _round_up(slots1 + slots2, E)
    L_A = num_passes(n1, B) if tiered else 0
    R_A = R0 + L_A * B * E
    tile_nb = grid.num_tiles + 1 if tiered else grid.num_tiles
    L2 = num_passes(tile_nb, B)
    TAIL = _round_up(2 * K_CHUNK, E)
    R_L = R_A + L2 * B * E + TAIL
    return PartitionEngineSizes(n_pad, L1, n1, d1, d2_extra, m_cap, slots1, slots2, R0, L_A,
                                R_A, tile_nb, L2, TAIL, R_L, 2 if tiered else 1)


def depth_key(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """24-bit presort key: the positive-f32 bits of the depth >> 8, capped
    below PRESORT_NB; invalid Gaussians get PRESORT_NB (the sentinel)."""
    bits = torch.clamp_min(depth, 0.0).contiguous().view(torch.int32) >> 8
    key = torch.clamp_max(bits, PRESORT_NB - 1).to(torch.float32)
    return torch.where(valid, key, float(PRESORT_NB))


def _tile_of_cell(rx, ry, w, cell, grid_x: int) -> torch.Tensor:
    """[m, c] f32 tile id of cells `cell` [1, c] of rects at (rx, ry) of width w."""
    ty = ry[:, None] + cell // w[:, None]
    tx = rx[:, None] + cell % w[:, None]
    return (ty * grid_x + tx).to(torch.float32)


class PartitionTable(NamedTuple):
    table: torch.Tensor         # [nkey + 6 + 3 n_passes, R_L] the partitioned entry table
    tile_starts: torch.Tensor   # [T] int32
    tile_counts: torch.Tensor   # [T] int32
    big_list: torch.Tensor      # [m_cap] int32 ranks of the big pool, padded with n1
    presort: PartitionMeta
    rank: Optional[PartitionMeta]
    tile: PartitionMeta
    sizes: PartitionEngineSizes


def build_partition_table(grid: TileGrid, n: int, d_max: int, n_passes: int, d_small: int,
                          big_fraction: float, mean2d, conic, opacity, colors_stack, depth,
                          rect_min, rect_max, tiles_touched, valid) -> PartitionTable:
    """Presort, duplicate, partition: the engine's forward up to the blend
    (rasterize_pallas.py:2261-2392). Rows of the entry table: the key rows
    (rank, tile with tier 2; tile without), then x, y, conic a, b, c,
    opacity and r, g, b per color pass (colors_stack [n_passes, n, 3])."""
    sz = partition_engine_sizes(grid, n, d_max, d_small, big_fraction)
    dev = mean2d.device
    T = grid.num_tiles
    n1, d1, d2, m_cap = sz.n1, sz.d1, sz.d2_extra, sz.m_cap
    tiered = m_cap > 0
    with span("partition_presort"):
        rect_w = torch.clamp_min(rect_max[:, 0] - rect_min[:, 0], 1)
        cols = [depth_key(depth, valid), mean2d[:, 0], mean2d[:, 1], conic[:, 0], conic[:, 1],
                conic[:, 2], opacity]
        cols += [colors_stack[i, :, c] for i in range(n_passes) for c in range(3)]
        cols += [rect_min[:, 0], rect_min[:, 1], rect_w, torch.clamp_max(tiles_touched, d_max),
                 valid]
        # padding columns are key-0 entries with valid = 0, as in the JAX engine
        ptab = torch.zeros((len(cols), sz.n_pad), dtype=torch.float32, device=dev)
        ptab[:, :n] = torch.stack([c.to(torch.float32) for c in cols])
        psorted, pmeta = radix_partition(ptab, PRESORT_NB, B=B, E=E)
        del ptab

    with span("partition_dup"):
        rm = 7 + 3 * n_passes                  # first rect row of the presort table
        rminx = psorted[rm].to(torch.int32)
        rminy = psorted[rm + 1].to(torch.int32)
        rw = torch.clamp_min(psorted[rm + 2].to(torch.int32), 1)
        tt_r = psorted[rm + 3].to(torch.int32)
        valid_r = psorted[rm + 4] > 0.5
        cells1 = torch.arange(d1, dtype=torch.int32, device=dev)[None, :]
        tile1 = _tile_of_cell(rminx, rminy, rw, cells1, grid.grid_x)
        dup1 = (cells1 < tt_r[:, None]) & valid_r[:, None]
        P = 6 + 3 * n_passes
        dtab = torch.empty((sz.nkey + P, sz.R0), dtype=torch.float32, device=dev)
        s1, s2 = sz.slots1, sz.slots1 + sz.slots2
        trow = sz.nkey - 1
        if tiered:
            dtab[trow, :s1].view(n1, d1).copy_(torch.where(dup1, tile1 + 1.0, 0.0))
            ranks = torch.arange(n1, dtype=torch.float32, device=dev)[:, None]
            dtab[0, :s1].view(n1, d1).copy_(torch.where(dup1, ranks, float(n1)))
            # the first m_cap ranks with more than d1 cells (no host sync:
            # ranks past the pool scatter into a dropped extra slot)
            is_big = (tt_r > d1) & valid_r
            brank = torch.cumsum(is_big.to(torch.int64), 0) - 1
            slot = torch.where(is_big & (brank < m_cap), brank, m_cap)
            big_list = torch.full((m_cap + 1,), n1, dtype=torch.int64, device=dev)
            big_list.scatter_(0, slot, torch.arange(n1, device=dev))
            big_list = big_list[:m_cap].to(torch.int32)
            bvalid = big_list < n1
            blc = torch.clamp_max(big_list, n1 - 1).long()
            cells2 = d1 + torch.arange(d2, dtype=torch.int32, device=dev)[None, :]
            tile2 = _tile_of_cell(rminx[blc], rminy[blc], rw[blc], cells2, grid.grid_x)
            dup2 = (cells2 < tt_r[blc][:, None]) & bvalid[:, None]
            dtab[trow, s1:s2].view(m_cap, d2).copy_(torch.where(dup2, tile2 + 1.0, 0.0))
            dtab[0, s1:s2].view(m_cap, d2).copy_(
                torch.where(dup2, blc.to(torch.float32)[:, None], float(n1)))
            dtab[0, s2:] = float(n1)
            dtab[trow, s2:] = 0.0
            dtab[sz.nkey:, s1:s2].view(P, m_cap, d2).copy_(psorted[1:1 + P][:, blc, None]
                                                            .expand(P, m_cap, d2))
        else:
            dtab[trow, :s1].view(n1, d1).copy_(torch.where(dup1, tile1, float(T)))
            dtab[trow, s2:] = float(T)
            big_list = torch.zeros((0,), dtype=torch.int32, device=dev)
        dtab[sz.nkey:, :s1].view(P, n1, d1).copy_(psorted[1:1 + P, :, None].expand(P, n1, d1))
        dtab[sz.nkey:, s2:] = 0.0
        del psorted

    rmeta = None
    if tiered:
        with span("partition_rank"):
            dtab, rmeta = radix_partition(dtab, n1, B=B, E=E, key_row=0)
    with span("partition_tile"):
        tsorted, tmeta = radix_partition(dtab, sz.tile_nb, B=B, E=E, key_row=trow,
                                         tail_pad=sz.TAIL)
        starts, counts = bucket_ranges(tmeta)
        if tiered:
            starts, counts = starts[1:].contiguous(), counts[1:].contiguous()
    return PartitionTable(tsorted, starts, counts, big_list, pmeta, rmeta, tmeta, sz)


class PartitionBlend(torch.autograd.Function):
    """The partition-engine blend with its backward: the counterpart of
    `_make_partition_blend_vjp` (single chip).

    Forward: build_partition_table and one fused K1 launch over the entry
    table's attribute rows (the JAX engine calls K1 once per pass; the
    passes share alpha and T, so one fused launch computes the same);
    returns the colors with the background [n_passes, T, 256, 3] and each
    pass's final_T [n_passes, T, 256] (equal values; each pass's own
    cotangent reaches the backward, as in the JAX engine). Backward: the
    cotangent pack, K2 with its two per-pass abs rows, dbg, K6 through the tile
    and rank partitions, the rank sums with K3, K6 through the presort.

    The abs-gradient hook [N, 2] receives the JAX partition engine's
    per-axis channels (its K2 rows 9:11 summed over its one launch per pass,
    rasterize_pallas.py:2426-2438), scaled by ndc_scale: ch0 = sum over
    passes of sx sum|dmx_pix| of that pass's gradient alone, ch1 = the same
    of sy sum|dmy_pix|. The sort engine keeps its fused channel instead;
    for one pass both have the same g_abs.sum(-1), which is all the
    trainer reads.

    Under a mesh (`mesh`, the JAX engine's tile-sharded path,
    rasterize_pallas.py:2227-2232, :2374-2405, :2483-2530) the binning stays
    replicated (every rank bins every Gaussian with K5), and each rank
    blends its band of T_band = ceil(T / D) tiles with K1 at tile base
    rank * T_band; the outputs are the band's [n_passes, T_band, 256, 3]
    and [n_passes, T_band, 256]. Its backward runs K2 on the band, zeroes
    the entry rows outside the band's segment, reduces them to the ranks'
    sums (K6, rank sums, K3) and sums those over the ranks, as it does the
    background's gradient: every rank returns the same gradients."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors_stack, absgrad_hook, bg, depth, rect_min,
                rect_max, tiles_touched, valid, grid: TileGrid, max_tiles_per_gaussian: int,
                d_small: int, big_fraction: float, ndc_scale: Tuple[float, float],
                aux: Dict[str, torch.Tensor], mesh: Optional[TileMesh] = None):
        del absgrad_hook   # its gradient is the fused abs channel
        n, n_passes = mean2d.shape[0], colors_stack.shape[0]
        pt = build_partition_table(grid, n, max_tiles_per_gaussian, n_passes, d_small,
                                   big_fraction, mean2d, conic, opacity, colors_stack, depth,
                                   rect_min, rect_max, tiles_touched, valid)
        nkey = pt.sizes.nkey
        attrs = pt.table[nkey:nkey + 6 + 3 * n_passes]
        starts, counts, tile_base, T = pt.tile_starts, pt.tile_counts, 0, grid.num_tiles
        if mesh is not None:
            starts, counts, tile_base, T = band_of(starts, counts, grid.num_tiles, mesh)
        with span("blend_kernel"):
            # K1 and K2 take the tiles in one order, computed once a step
            order = blend.tile_order(counts, T)
            colors, final_t, walked, _sat = blend.blend_forward(
                attrs, starts, counts, grid, n_passes, order=order, tile_base=tile_base,
                num_tiles=T)
        ctx.save_for_backward(pt.table, starts, counts, pt.big_list, colors, final_t, bg, order)
        ctx.metas = (pt.presort, pt.rank, pt.tile)
        ctx.grid, ctx.ndc_scale, ctx.n, ctx.sizes = grid, ndc_scale, n, pt.sizes
        ctx.mesh, ctx.tile_base = mesh, tile_base
        aux.update(table=attrs, entry_table=pt.table, tile_starts=starts,
                   tile_counts=counts, walked=walked, big_list=pt.big_list,
                   presort_meta=pt.presort, rank_meta=pt.rank, tile_meta=pt.tile)
        return colors + final_t[..., None] * bg, final_t.repeat(n_passes, 1, 1)

    @staticmethod
    def backward(ctx, g_color, g_final_t):
        table, starts, counts, big_list, colors, final_t, bg, order = ctx.saved_tensors
        pmeta, rmeta, tmeta = ctx.metas
        sz, n, mesh = ctx.sizes, ctx.n, ctx.mesh
        n_passes, T = colors.shape[0], colors.shape[1]
        G0 = blend.grad_rows(n_passes)
        G = G0 + 1                  # with the two per-axis abs rows, less the fused row
        g_color = g_color.contiguous()
        # cotangent pack: each pass's gt_eff, and their sum (final_T is shared)
        gte_pass = (g_final_t + torch.einsum("itpc,c->itp", g_color, bg)).contiguous()
        gte = gte_pass.sum(0)
        with span("blend_bwd_kernel"):
            # K2 allocates its rows zeroed and writes only the tile segments'
            # entries, so every other position (the dead bucket of empty
            # slots and rank-pass holes, the gaps, the tail) holds 0: the JAX
            # engine's live mask (rasterize_pallas.py:2535-2542)
            eg = blend.blend_backward(table[sz.nkey:sz.nkey + 6 + 3 * n_passes], starts, counts,
                                      ctx.grid, n_passes, g_color, gte, colors, final_t,
                                      ctx.ndc_scale, gte_pass, order=order,
                                      tile_base=ctx.tile_base, num_tiles=T)
            if mesh is not None:
                # only the band's own segment: the rank's other entries are
                # another rank's (K2 leaves them 0; the mask states it)
                lo, hi = starts[0], starts[T - 1] + counts[T - 1]
                pos = torch.arange(eg.shape[1], device=eg.device)
                eg.mul_(((pos >= lo) & (pos < hi)).to(eg.dtype))
            # the y abs sum replaces the fused row 6 (grad_rows' layout), so
            # that rows [0, G) go back through the partitions
            eg[6].copy_(eg[G0 + 1])
            eg = eg[:G]
        dbg = torch.einsum("itpc,tp->c", g_color, final_t)
        if mesh is not None:
            all_reduce_(dbg, mesh)
        with span("unpartition"):
            slotg = radix_unpartition(eg, tmeta)
            del eg
            if rmeta is not None:
                slotg = radix_unpartition(slotg, rmeta)
        with span("rank_sums"):
            s1 = sz.slots1
            sums = slotg[:, :s1].reshape(G, sz.n1, sz.d1).sum(-1)
            if sz.m_cap > 0:
                bigs = slotg[:, s1:s1 + sz.slots2].reshape(G, sz.m_cap, sz.d2_extra).sum(-1)
            del slotg
        if sz.m_cap > 0:
            with span("tier2_merge"):
                blend.tier2_merge(sums, big_list, bigs)
        if mesh is not None:
            with span("all_reduce"):
                all_reduce_(sums, mesh)
        with span("unpartition"):
            orig = radix_unpartition(sums, pmeta)[:, :n]
        sx, sy = ctx.ndc_scale
        dabs = torch.stack([orig[G0] * float(sx), orig[6] * float(sy)], dim=-1)
        dcolors = torch.stack([orig[7 + 3 * i:10 + 3 * i].T for i in range(n_passes)])
        return (orig[0:2].T, orig[2:5].T, orig[5], dcolors, dabs, dbg,
                None, None, None, None, None, None, None, None, None, None, None, None)


def band_of(starts: torch.Tensor, counts: torch.Tensor, num_tiles: int, mesh: TileMesh):
    """This rank's band of a whole grid's tile segments: (starts [T_band +
    1], counts [T_band], its tile base, T_band), the tiles padded to D
    bands with empty segments at the table's end (rasterize_pallas.py:
    2387-2391)."""
    D = mesh.size
    T_band = -(-num_tiles // D)
    pad = T_band * D - num_tiles
    real_end = starts[num_tiles - 1:num_tiles] + counts[num_tiles - 1:num_tiles]
    starts_p = torch.cat([starts[:num_tiles], real_end.expand(pad + 1)])
    counts_p = torch.cat([counts[:num_tiles], counts.new_zeros(pad)])
    t0 = mesh.rank * T_band
    return (starts_p[t0:t0 + T_band + 1].contiguous(), counts_p[t0:t0 + T_band].contiguous(),
            t0, T_band)

