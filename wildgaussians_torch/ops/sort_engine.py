"""Single-chip sort-engine binning: corner cull, visible-cell compaction, one
sort by (tile | depth) key, and the blend kernel's entry table.

Counterpart of the unpacked (`pack16=False`) sort engine of
`wildgaussians_tpu/ops/rasterize_pallas.py` (`_tile_of_cell`,
`_cull_threshold`, `_cell_visible`, `visible_cell_counts`,
`_cull_pack_entries`, `_sort_engine_sizes`, `_build_sorted_table`) with its
saturation cull (`SUPERTILE_F`, `supertile_shape`, `pool_sat_depth`,
`_cell_sat_corners`, `_cell_sat_keep`, `sat_depth_from_pack`). The entry
order must equal the JAX package's exactly:

  - slots are CELL-MAJOR: tier-1 slot (j, g) = j * n + g for the first d1
    visible cells of every Gaussian, then the tier-2 slots
    n * d1 + j2 * m_cap + b for visible cells [d1, d_max) of the first m_cap
    Gaussians with more than d1 visible cells (`big_list`);
  - the key is (tile << depth_bits) | truncated positive-f32 depth bits,
    0xFFFFFFFF for an empty slot, held here in int64 so that the unsigned
    order is kept;
  - the order is by (key, slot), i.e. a stable sort by key.

The JAX package sorts the attributes along as payload rows; here the sort
gives the slot order and the attributes are gathered after it (slot ->
Gaussian), which yields the same table. Sorting, searchsorted and gathers
are plain torch: the JAX package ran them as `lax.sort` / XLA too.

The saturation cull: K1 reports, per tile, whether every pixel stopped and
how many entries that took; `sat_depth_from_walk` maps that to the depth
at the end of the JAX kernel's 256-entry exit chunk, `pool_sat_depth`
pools the tiles' depths into a supertile map, and a later binning under
that map drops every cell whose Gaussian lies at or beyond its supertile's
depth (the JAX package's one-hot sums over the supertiles are a TPU layout
choice: a gather by supertile id reads the same values).
"""
from typing import List, NamedTuple, Optional

import torch

from .rasterize_tiled import ALPHA_MIN, TileGrid

_EMPTY_KEY = 0xFFFFFFFF


class SortEngineSizes(NamedTuple):
    d1: int          # cheap slots every Gaussian owns
    d2_extra: int    # deep slots of a big Gaussian
    m_cap: int       # big-Gaussian pool
    R: int           # total slots
    depth_bits: int  # low key bits that hold the depth


def _sort_engine_sizes(grid: TileGrid, n: int, d_max: int,
                       d_small: int, big_fraction: float) -> SortEngineSizes:
    d1 = min(d_small, d_max)
    d2_extra = d_max - d1
    m_cap = min(max(int(n * big_fraction), 8), n) if d2_extra > 0 else 0
    R = n * d1 + m_cap * d2_extra
    tile_bits = max(int(grid.num_tiles + 1).bit_length(), 1)
    return SortEngineSizes(d1, d2_extra, m_cap, R, 32 - tile_bits)


def _tile_of_cell(rmin: torch.Tensor, rw: torch.Tensor, j, grid_x: int) -> torch.Tensor:
    """Tile id of a Gaussian's j-th rect cell. rmin [m,2]; rw [m]; j an int,
    or [c, 1] cells for a [c, m] result."""
    ty = rmin[:, 1] + j // rw
    tx = rmin[:, 0] + j % rw
    return (ty * grid_x + tx).to(torch.int32)


def _cull_threshold(opacity: torch.Tensor) -> torch.Tensor:
    """An entry is visible in a tile iff opac * exp(-q_min/2) >= 1/255,
    i.e. q_min <= this value."""
    return 2.0 * torch.log(torch.clamp_min(opacity, 1e-12) * (1.0 / ALPHA_MIN))


def _cell_visible(tile_m, mean_m2, con_m, thr_m, grid: TileGrid) -> torch.Tensor:
    """Exact tile-corner cull: True iff the minimum over the tile's pixel box
    of the conic quadratic q(d) is <= thr. The minimum is at the center (if
    inside) or on an edge, where the free coordinate minimizes to
    clamp(-b*dx/c)."""
    ts = float(grid.tile_size)
    a_, b_, c_ = con_m[:, 0], con_m[:, 1], con_m[:, 2]
    ox = (tile_m % grid.grid_x).to(torch.float32) * ts
    oy = (tile_m // grid.grid_x).to(torch.float32) * ts
    dxh = mean_m2[:, 0] - ox
    dxl = dxh - (ts - 1.0)
    dyh = mean_m2[:, 1] - oy
    dyl = dyh - (ts - 1.0)

    def q_of(dx, dy):
        return a_ * dx * dx + 2.0 * b_ * dx * dy + c_ * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    inside = (dxl <= 0.0) & (dxh >= 0.0) & (dyl <= 0.0) & (dyh >= 0.0)
    q = torch.where(inside, 0.0, torch.inf)
    for dx in (dxl, dxh):
        dy = clip(-b_ * dx / torch.clamp_min(c_, 1e-12), dyl, dyh)
        q = torch.minimum(q, q_of(dx, dy))
    for dy in (dyl, dyh):
        dx = clip(-b_ * dy / torch.clamp_min(a_, 1e-12), dxl, dxh)
        q = torch.minimum(q, q_of(dx, dy))
    return q <= thr_m


# rect cells taken together by _select_cells: its launches fall with the
# chunk, its temporaries (a few [chunk, m] tensors) grow with it
_CELL_CHUNK = 8


SUPERTILE_F = 4   # tiles per supertile edge of the saturation-cull map


def supertile_shape(grid: TileGrid):
    """(sy, sx) of the saturation-depth supertile map of `grid`."""
    f = SUPERTILE_F
    return ((grid.grid_y + f - 1) // f, (grid.grid_x + f - 1) // f)


def pool_sat_depth(sat_depth: torch.Tensor, grid: TileGrid, margin: float = 1.25) -> torch.Tensor:
    """Per-tile saturation depths [T] -> the supertile map [sy, sx] for a
    later binning's cull: the largest depth over each supertile's tiles
    (an unsaturated tile's +inf, or the padding past the grid's edge, keeps
    its whole supertile), times `margin`."""
    f = SUPERTILE_F
    sy, sx = supertile_shape(grid)
    m = torch.full((sy * f, sx * f), torch.inf, dtype=torch.float32, device=sat_depth.device)
    m[:grid.grid_y, :grid.grid_x] = sat_depth.reshape(grid.grid_y, grid.grid_x)
    return m.reshape(sy, f, sx, f).amax(dim=(1, 3)) * torch.tensor(margin, dtype=torch.float32)


def _cell_sat_corners(rmin, rw, tt, sat_super: Optional[torch.Tensor]):
    """[(row, column, map depth)] of the 4 corner supertiles of each
    Gaussian's tile rect, each [m] (rows and columns unclipped), or None
    without a map. A cell in any other supertile (a rect more than 2
    supertiles across) is never culled."""
    if sat_super is None:
        return None
    f = SUPERTILE_F
    sy, sx = sat_super.shape
    rh = torch.clamp_min((tt + rw - 1) // torch.clamp_min(rw, 1), 1)
    c0x = rmin[:, 0] // f
    c1x = (rmin[:, 0] + rw - 1) // f
    c0y = rmin[:, 1] // f
    c1y = (rmin[:, 1] + rh - 1) // f
    flat = sat_super.reshape(-1)
    return [(cy, cx, flat[torch.clamp(cy * sx + cx, 0, sy * sx - 1).long()])
            for cy, cx in ((c0y, c0x), (c0y, c1x), (c1y, c0x), (c1y, c1x))]


def _cell_sat_keep(tj, depth_m, corners, grid: TileGrid) -> torch.Tensor:
    """Whether the cells at tiles `tj` survive the saturation cull: unless
    the Gaussian's depth is at or beyond the largest depth of the corner
    supertiles the cell lies in."""
    f = SUPERTILE_F
    sjx = (tj % grid.grid_x) // f
    sjy = (tj // grid.grid_x) // f
    thr = torch.full(tj.shape, -torch.inf, dtype=torch.float32, device=tj.device)
    matched = torch.zeros(tj.shape, dtype=torch.bool, device=tj.device)
    for cy, cx, t in corners:
        m = (sjx == cx) & (sjy == cy)
        thr = torch.maximum(thr, torch.where(m, t, -torch.inf))
        matched = m | matched
    thr = torch.where(matched, thr, torch.inf)
    return depth_m < thr


def _select_cells(grid: TileGrid, d_max: int, rmin, rw, tt, vald, mean_m2,
                  con_m, thr_m, d_lo: int, d_hi: int, depth_m=None,
                  sat_super: Optional[torch.Tensor] = None):
    """Tiles of the visible cells packed to slots [d_lo, d_hi), and the total
    visible-cell count of each Gaussian. With a saturation map `sat_super`
    (and the Gaussians' `depth_m`), a cell must also survive its cull.

    The rect cells are culled _CELL_CHUNK at a time ([chunk, m] tensors,
    the same elementwise operations as one cell at a time); a visible cell
    whose rank among its Gaussian's visible cells falls in [d_lo, d_hi) is
    scattered to that slot (every other cell to a spare row). So a call
    costs O(d_max / _CELL_CHUNK) launches, not O(d_max (d_hi - d_lo)): with
    the tile budget grown to 128, one launch per cell and slot made ~20k
    launches a step."""
    m = rw.shape[0]
    dev = rw.device
    corners = _cell_sat_corners(rmin, rw, tt, sat_super)
    prefix = torch.zeros((m,), dtype=torch.int32, device=dev)
    n_sel = d_hi - d_lo
    out = torch.zeros((n_sel + 1, m), dtype=torch.int32, device=dev)   # the last row: spare
    for j0 in range(0, d_max, _CELL_CHUNK):
        j = torch.arange(j0, min(j0 + _CELL_CHUNK, d_max), dtype=torch.int32,
                         device=dev)[:, None]
        tj = _tile_of_cell(rmin, rw, j, grid.grid_x)
        vj = (j < tt[None]) & vald[None] & _cell_visible(tj, mean_m2, con_m, thr_m, grid)
        if corners is not None:
            vj = vj & _cell_sat_keep(tj, depth_m, corners, grid)
        vi = vj.to(torch.int32)
        rank = prefix[None] + torch.cumsum(vi, dim=0, dtype=torch.int32) - vi
        if n_sel > 0:
            slot = torch.where(vj & (rank >= d_lo) & (rank < d_hi), rank - d_lo, n_sel)
            out.scatter_(0, slot.long(), tj)
        prefix = prefix + vi.sum(dim=0, dtype=torch.int32)
    return list(out[:n_sel]), prefix


def visible_cell_counts(mean2d, conic, opacity, rect_min, rect_max,
                        tiles_touched, valid, grid: TileGrid, d_max: int,
                        sat_super: Optional[torch.Tensor] = None, depth=None) -> torch.Tensor:
    """Per-Gaussian count of corner-cull-surviving rect cells (first d_max),
    under the saturation cull of `sat_super` (with the Gaussians' `depth`)
    when given. The render path reads the same count from
    `SortedTable.vis_count`."""
    rect_w = torch.clamp_min(rect_max[:, 0] - rect_min[:, 0], 1)
    return _select_cells(grid, d_max, rect_min, rect_w, tiles_touched, valid, mean2d,
                         conic, _cull_threshold(opacity), 0, 0, depth, sat_super)[1]


def _quantized_key(tile_m, depth_m, dup_m, depth_bits: int) -> torch.Tensor:
    """[tile | truncated positive-f32 depth bits] as int64; empty slots get
    0xFFFFFFFF."""
    dbits = (torch.clamp_min(depth_m, 0.0).view(torch.int32).to(torch.int64)
             >> (31 - depth_bits))
    dq = torch.clamp_max(dbits, (1 << depth_bits) - 1)
    key = (tile_m.to(torch.int64) << depth_bits) | dq
    return torch.where(dup_m, key, torch.full_like(key, _EMPTY_KEY))


def _cull_pack_entries(grid: TileGrid, sizes: SortEngineSizes, d_max: int,
                       mean2d, conic, opacity, depth, rect_min, rect_max,
                       tiles_touched, valid, sat_super=None):
    """Corner cull (and the saturation cull under `sat_super`) + visible-cell
    compaction in slot order.

    Returns (key_all [R] int64, slot_gaussian [R] int64, big_list [m_cap]
    int32, vis_count [n] int32): the sort key of every slot, the Gaussian
    each slot belongs to, the big-Gaussian pool (ascending indices, padded
    with n) and each Gaussian's visible-cell count (`visible_cell_counts`)."""
    n = valid.shape[0]
    d1, m_cap, depth_bits = sizes.d1, sizes.m_cap, sizes.depth_bits
    dev = valid.device
    rect_w = torch.clamp_min(rect_max[:, 0] - rect_min[:, 0], 1)
    cull_thr = _cull_threshold(opacity)

    # tier 1: first d1 visible cells of every Gaussian
    sel1, vis_count = _select_cells(grid, d_max, rect_min, rect_w, tiles_touched,
                                    valid, mean2d, conic, cull_thr, 0, d1, depth, sat_super)
    key_parts: List[torch.Tensor] = [
        _quantized_key(sel1[jo], depth, jo < vis_count, depth_bits) for jo in range(d1)]
    slot_parts = [torch.arange(n, device=dev).repeat(d1)]

    # tier 2: visible cells [d1, d_max) of the first m_cap big Gaussians
    if m_cap > 0:
        is_big = (vis_count > d1) & valid
        first = torch.nonzero(is_big).flatten()[:m_cap].to(torch.int32)
        big_list = torch.cat([first, torch.full((m_cap - first.shape[0],), n,
                                                dtype=torch.int32, device=dev)])
        bvalid = big_list < n
        bl = torch.clamp_max(big_list, n - 1).long()
        sel2, vis_b = _select_cells(grid, d_max, rect_min[bl], rect_w[bl],
                                    tiles_touched[bl], bvalid, mean2d[bl],
                                    conic[bl], cull_thr[bl], d1, d_max, depth[bl], sat_super)
        for j2 in range(d1, d_max):
            key_parts.append(_quantized_key(sel2[j2 - d1], depth[bl], j2 < vis_b, depth_bits))
        slot_parts.append(bl.repeat(sizes.d2_extra))
    else:
        big_list = torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.cat(key_parts), torch.cat(slot_parts), big_list, vis_count


class SortedTable(NamedTuple):
    table: torch.Tensor        # [6 + 3 n_passes, N] f32, N = tile_starts[-1] binned entries
    sorted_flat: torch.Tensor  # [R] int32 slot of each sorted position
    tile_starts: torch.Tensor  # [T+1] int32
    tile_counts: torch.Tensor  # [T] int32
    big_list: torch.Tensor     # [m_cap] int32
    sorted_key: torch.Tensor   # [R] int64
    vis_count: torch.Tensor    # [n] int32 visible cells of each Gaussian (first d_max)


def _build_sorted_table(grid: TileGrid, n: int, d_max: int, n_passes: int,
                        d_small: int, big_fraction: float, mean2d, conic,
                        opacity, colors_stack, depth, rect_min, rect_max,
                        tiles_touched, valid, sat_super=None) -> SortedTable:
    """Cull (under the saturation map `sat_super` too, when given), compact,
    sort by (key, slot) and gather the blend kernel's entry table. Rows: x, y, conic a, b, c, opacity, then r, g, b per color pass
    (colors_stack [n_passes, n, 3]). Only the N binned entries are gathered:
    the JAX package pads the table to R_pad for its DMA floors, which the
    port does not need."""
    sizes = _sort_engine_sizes(grid, n, d_max, d_small, big_fraction)
    key_all, slot_gaussian, big_list, vis_count = _cull_pack_entries(
        grid, sizes, d_max, mean2d, conic, opacity, depth, rect_min, rect_max,
        tiles_touched, valid, sat_super)
    sorted_key, order = torch.sort(key_all, stable=True)
    bounds = (torch.arange(grid.num_tiles + 1, dtype=torch.int64, device=key_all.device)
              << sizes.depth_bits)
    tile_starts = torch.searchsorted(sorted_key, bounds, side="left").to(torch.int32)
    tile_counts = tile_starts[1:] - tile_starts[:-1]
    n_binned = int(tile_starts[-1])
    attrs = torch.cat([mean2d.T, conic.T, opacity[None],
                       colors_stack.permute(0, 2, 1).reshape(3 * n_passes, n)])
    table = attrs[:, slot_gaussian[order[:n_binned]]].contiguous()
    return SortedTable(table, order.to(torch.int32), tile_starts, tile_counts,
                       big_list, sorted_key, vis_count)


def sat_depth_from_walk(walked: torch.Tensor, saturated: torch.Tensor,
                        tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                        sorted_key: torch.Tensor, depth_bits: int, K: int = 256) -> torch.Tensor:
    """Per-tile saturation depth [T] from K1's `walked` and `saturated`
    (the JAX package's `sat_depth_from_pack`, at its granularity): the JAX
    kernel walks 256-entry chunks from the 128-aligned floor of each tile's
    start and reports the chunk after which every pixel had stopped, so the
    depth is read from the sorted key at the end of that chunk, clipped to
    the tile's entries (the key's low bits are the top bits of the
    positive-f32 depth: a lower bound). A tile that did not saturate, or
    has no entries, reads +inf."""
    T = tile_counts.shape[0]
    starts = tile_starts[:T].long()
    counts = tile_counts.long()
    shift = starts % 128
    c_fin = (shift + walked.long() + (K - 1)) // K
    last = torch.maximum(starts + counts - 1, starts)
    pos = torch.minimum(torch.maximum(starts - shift + c_fin * K, starts), last)
    key_at = sorted_key[torch.clamp_max(pos, sorted_key.shape[0] - 1)]
    bits = (key_at & ((1 << depth_bits) - 1)) << (31 - depth_bits)
    dep = bits.to(torch.int32).view(torch.float32)
    return torch.where((saturated != 0) & (counts > 0), dep, torch.inf)
