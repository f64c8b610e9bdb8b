"""The public rasterization API: preprocess, binning, tile blend.

Counterpart of `wildgaussians_tpu/ops/rasterize.py`, with its signatures,
defaults and backend names:
  - "tiled":     the plain torch tiled blend with its hand-derived backward
                 (ops/rasterize_tiled.py, binning ops/binning.py), the default;
  - "pallas":    the kernels' path (ops/blend.py: the sort, partition or
                 gather engine, K1-K3, K5, K6). On CUDA tensors it always launches
                 the CUDA kernels, and raises if they fail to build or launch;
                 on CPU tensors it runs their plain versions;
  - "reference": the O(N H W) oracle (ops/rasterize_reference.py), for tests.
No backend switches to another by itself. The sort-once / blend-many static
viewer path is `bin_static` + `render_static`, over K4
(ops/static_blend.py).

`engine_overflow_count` is the renderer's truncation count, from the
engine's own visible-cell counts; `overflow_count` the JAX package's
public one, from the preprocess output.
"""
from typing import NamedTuple, Optional

import torch

from ..cameras import CameraParams
from .binning import bin_gaussians
from .gaussians import PreprocessOutput, compute_cov3d, preprocess
from .rasterize_reference import rasterize_reference
from .rasterize_tiled import TileGrid, make_grid, rasterize_tiled, tiles_to_image
from .sort_engine import visible_cell_counts


def mark_visible(means3d: torch.Tensor, camera: CameraParams) -> torch.Tensor:
    """Frustum visibility [N] bool (the reference's markVisible ->
    in_frustum: visible iff the view-space z > 0.2)."""
    z = (torch.cat([means3d, torch.ones_like(means3d[..., :1])], dim=-1)
         * camera.viewmatrix[2]).sum(-1)
    return z > 0.2


def engine_overflow_count(tiles_touched: torch.Tensor, vis_count: Optional[torch.Tensor],
                          max_tiles_per_gaussian: int, *, d_small: int = 4,
                          big_fraction: float = 0.16, binning: str = "sort",
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated-contribution count of the pallas path, from the engine's
    own counts: (a) Gaussians whose tile rect exceeds
    max_tiles_per_gaussian and (b) big Gaussians beyond the big-pool
    capacity, which keep only their cheap slots. tiles_touched [n] is
    preprocess's uncapped count.

    d_small is the engine's own (for "partition" the floored
    `partition_engine.engine_d_small`, as the caller passed it to the
    engine). binning "sort": a big Gaussian has more than d_small visible
    cells (vis_count [n], the sort engine's `SortedTable.vis_count`, the
    visible cells among the first max_tiles_per_gaussian, under the
    saturation cull when the binning ran with a map). "partition" and
    "gather": more than d_small raw rect cells among the valid Gaussians
    (valid [n]); vis_count is unused. The JAX package recounts the visible
    cells here and lets XLA merge that with the engine's own count; eager
    torch would run the corner cull twice."""
    overflow = torch.sum(tiles_touched > max_tiles_per_gaussian)
    if max_tiles_per_gaussian > d_small:
        m_cap = max(int(tiles_touched.shape[0] * big_fraction), 8)
        if binning in ("partition", "gather"):
            n_big = torch.sum((tiles_touched > d_small) & valid)
        else:
            n_big = torch.sum(vis_count > d_small)
        overflow = overflow + torch.clamp_min(n_big - m_cap, 0)
    return overflow


def overflow_count(pre: PreprocessOutput, backend: str, max_tiles_per_gaussian: int, *,
                   d_small: int = 4, big_fraction: float = 0.16, binning: str = "sort",
                   grid: Optional[TileGrid] = None, sat_super=None) -> torch.Tensor:
    """Truncated-contribution count, two-tier-aware for the pallas backend
    (the JAX package's): (a) Gaussians whose tile rect exceeds
    max_tiles_per_gaussian and, for pallas, (b) big Gaussians beyond the
    big-pool capacity. The sort engine (with a grid) classifies on visible
    cells, under the saturation cull of `sat_super` when the binning runs
    with that map, the partition and gather engines on raw rect cells with
    d_small floored at 6."""
    overflow = torch.sum(pre.tiles_touched > max_tiles_per_gaussian)
    if backend != "pallas":
        return overflow
    n = pre.valid.shape[0]
    if binning == "sort" and grid is not None:
        if max_tiles_per_gaussian > d_small:
            m_cap = max(int(n * big_fraction), 8)
            vis = visible_cell_counts(pre.mean2d, pre.conic, pre.opacity, pre.rect_min,
                                      pre.rect_max, pre.tiles_touched, pre.valid, grid,
                                      max_tiles_per_gaussian, sat_super=sat_super,
                                      depth=pre.depth)
            overflow = overflow + torch.clamp_min(torch.sum(vis > d_small) - m_cap, 0)
        return overflow
    d_eff = max(d_small, 6) if binning in ("partition", "gather") else d_small
    if max_tiles_per_gaussian > d_eff:
        m_cap = max(int(n * big_fraction), 8)
        n_big = torch.sum((pre.tiles_touched > d_eff) & pre.valid)
        overflow = overflow + torch.clamp_min(n_big - m_cap, 0)
    return overflow


class RasterizeResult(NamedTuple):
    color: torch.Tensor         # [H,W,3]
    final_T: torch.Tensor       # [H,W]  (accumulation = 1 - final_T)
    radii: torch.Tensor         # [N] int32 (visibility_filter = radii > 0)
    num_rendered: torch.Tensor  # [] int
    overflow: torch.Tensor      # [] int truncated-rect count


def rasterize_gaussians(means3d: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
                        opacities: torch.Tensor, colors: torch.Tensor, camera: CameraParams,
                        width: int, height: int, *, kernel_size: float,
                        absgrad_hook: Optional[torch.Tensor] = None,
                        alive: Optional[torch.Tensor] = None,
                        bg: Optional[torch.Tensor] = None, backend: str = "tiled",
                        tile_size: int = 16, max_tiles_per_gaussian: int = 64,
                        chunk: int = 256, batch_tiles: int = 64, sort_mode: str = "quantized",
                        d_small: int = 4, big_fraction: float = 0.16, binning: str = "sort",
                        pack16: bool = True, scale_modifier: float = 1.0,
                        cov3d: Optional[torch.Tensor] = None,
                        mean2d_hook: Optional[torch.Tensor] = None,
                        ndc_scale=None) -> RasterizeResult:
    """Render activated Gaussians (cf. the reference's
    GaussianRasterizer.forward with colors_precomp).

    opacities [N] post-activation (with the 3D filter's compensation);
    colors [N,3] precomputed. Differentiable wherever grad is enabled;
    `absgrad_hook` [N,2] (zeros) receives the abs-gradient channels and
    `mean2d_hook` [N,2] (zeros) the screen-space gradient of the means.
    `pack16` is accepted and has no effect: the port's tables are always
    f32, the JAX package's `pack16=False`. The pallas backend takes
    `binning` "sort", "partition" or "gather" and needs 16x16 tiles and
    chunk 256 (its kernels'); `sort_mode` and `batch_tiles` are the tiled
    backend's."""
    del pack16
    n = means3d.shape[0]
    dev = means3d.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    if absgrad_hook is None:
        absgrad_hook = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    if cov3d is None:
        cov3d = compute_cov3d(scales, rotations, scale_modifier)
    pre = preprocess(means3d, cov3d, opacities, camera, width, height, kernel_size,
                     tile_size=tile_size, alive=alive)
    if mean2d_hook is not None:
        # the screen-space gradient hook (the reference's means2D tensor)
        pre = pre._replace(mean2d=pre.mean2d + mean2d_hook)

    if backend == "reference":
        color, final_t = rasterize_reference(
            pre.mean2d, pre.depth, pre.conic, pre.opacity, colors, pre.valid, pre.rect_min,
            pre.rect_max, width=width, height=height, bg=bg, tile_size=tile_size)
        return RasterizeResult(color, final_t, pre.radius, torch.sum(pre.tiles_touched),
                               torch.zeros((), dtype=torch.int64, device=dev))

    grid = make_grid(width, height, tile_size)
    num_rendered = torch.sum(torch.clamp_max(pre.tiles_touched, max_tiles_per_gaussian))
    if backend == "tiled":
        hook = absgrad_hook
        if ndc_scale is not None:
            # per-axis channels: pre-scaling the hook scales its gradient by
            # the NDC factors (d/dh f(h s) = s f'(h s))
            hook = hook * torch.as_tensor(ndc_scale, dtype=torch.float32, device=dev)[None, :]
        b = bin_gaussians(pre, grid.grid_x, grid.grid_y, max_tiles_per_gaussian,
                          sort_mode=sort_mode)
        color, final_t = rasterize_tiled(pre.mean2d, pre.conic, pre.opacity, colors, hook,
                                         b.sorted_gidx, b.tile_starts, b.tile_counts, bg,
                                         grid=grid, chunk=chunk, batch_tiles=batch_tiles)
        overflow = overflow_count(pre, backend, max_tiles_per_gaussian)
    elif backend == "pallas":
        from .blend import rasterize_multi
        from .partition_engine import engine_d_small
        if chunk != 256:
            raise ValueError(f"the blend kernels walk 256-entry chunks, got chunk={chunk}")
        ((color, final_t),), aux = rasterize_multi(
            pre.mean2d, pre.conic, pre.opacity, [colors], pre.depth, pre.rect_min,
            pre.rect_max, pre.tiles_touched, pre.valid, bg, grid=grid,
            max_tiles_per_gaussian=max_tiles_per_gaussian, d_small=d_small,
            big_fraction=big_fraction, binning=binning, absgrad_hook=absgrad_hook,
            ndc_scale=(1.0, 1.0) if ndc_scale is None else tuple(float(x) for x in ndc_scale))
        overflow = engine_overflow_count(
            pre.tiles_touched, aux.get("vis_count"), max_tiles_per_gaussian,
            d_small=engine_d_small(d_small) if binning in ("partition", "gather") else d_small,
            big_fraction=big_fraction, binning=binning, valid=pre.valid)
    else:
        raise ValueError(f"Unknown rasterizer backend: {backend}")
    return RasterizeResult(color, final_t, pre.radius, num_rendered, overflow)


class StaticBinning(NamedTuple):
    """The sorted entry table of the static viewer path (see bin_static)."""
    table: torch.Tensor        # [9, N] f32 entries (x, y, conic, opacity, r, g, b)
    tile_starts: torch.Tensor  # [T+1] int32
    tile_counts: torch.Tensor  # [T] int32
    # the JAX package normalises colors for its rgb10 rows and multiplies
    # back in render_static; the port's rows are f32, so the scale is 1
    color_scale: torch.Tensor
    # [T] int32, the order in which K4 takes the tiles (longest list first),
    # computed once per binned pose
    tile_order: torch.Tensor


def bin_static(means3d, scales, rotations, opacities, colors, camera: CameraParams,
               width: int, height: int, *, kernel_size: float, alive=None,
               tile_size: int = 16, max_tiles_per_gaussian: int = 16, chunk: int = 256,
               d_small: int = 4, big_fraction: float = 0.16,
               scale_modifier: float = 1.0) -> StaticBinning:
    """Preprocess, cull and sort once for a static (scene, camera) pair: the
    sort-once / blend-many viewer path (re-blends for appearance or tone
    edits, or for a new background, without paying the sort). Pair with
    render_static."""
    from .static_blend import _make_static_renderer
    cov3d = compute_cov3d(scales, rotations, scale_modifier)
    pre = preprocess(means3d, cov3d, opacities, camera, width, height, kernel_size,
                     tile_size=tile_size, alive=alive)
    grid = make_grid(width, height, tile_size)
    bin_fn, _blend = _make_static_renderer(grid, chunk, means3d.shape[0],
                                           max_tiles_per_gaussian, 1, d_small, big_fraction)
    table, starts, counts, order = bin_fn(
        pre.mean2d, pre.conic, pre.opacity, colors[None], pre.depth, pre.rect_min, pre.rect_max,
        torch.clamp_max(pre.tiles_touched, max_tiles_per_gaussian), pre.valid)
    return StaticBinning(table, starts, counts,
                         torch.ones((), dtype=torch.float32, device=table.device), order)


def render_static(binning: StaticBinning, n: int, width: int, height: int, *, bg=None,
                  tile_size: int = 16, max_tiles_per_gaussian: int = 16, chunk: int = 256,
                  d_small: int = 4, big_fraction: float = 0.16):
    """Blend a pre-binned static scene with K4: (color [H,W,3], final_T
    [H,W]). `n` and the knobs must be those of the bin_static call. `bg`
    [3] may change every frame; it stays on the device."""
    from .static_blend import _make_static_renderer
    dev = binning.table.device
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    grid = make_grid(width, height, tile_size)
    _bin, blend_fn = _make_static_renderer(grid, chunk, n, max_tiles_per_gaussian, 1, d_small,
                                           big_fraction)
    scale = binning.color_scale.to(dev)
    # blend(c / s, bg / s) * s: compositing is linear in color (s = 1 here)
    pack = blend_fn(binning.table, binning.tile_starts, binning.tile_counts,
                    (bg / scale).to(torch.float32).contiguous(), binning.tile_order)[0]  # [4, T, 256]
    color = torch.stack([tiles_to_image(pack[c], grid) for c in range(3)], dim=-1)
    return color * scale, tiles_to_image(pack[3], grid)
