"""Tile binning of the tiled backend: every Gaussian's rect cells duplicated
into fixed slots, sorted by (tile, depth).

Counterpart of `wildgaussians_tpu/ops/binning.py` (the reference's CUB
pipeline: duplicateWithKeys, RadixSort, identifyTileRanges, on fixed-size
buffers). Every Gaussian owns `max_tiles_per_gaussian` slots, filled with
its rect cells row-major; the rest carry the sentinel tile (num_tiles) and
sort to the end. The entry order equals the JAX package's exactly: its
`lax.sort` is stable, so ties fall back to the flat slot index, and so
does `torch.sort(stable=True)` here.
"""
from typing import NamedTuple

import torch

from .gaussians import PreprocessOutput


class BinningResult(NamedTuple):
    sorted_gidx: torch.Tensor    # [R] int32 Gaussian of each entry, sorted by (tile, depth)
    tile_starts: torch.Tensor    # [T+1] int32
    tile_counts: torch.Tensor    # [T] int32
    num_rendered: torch.Tensor   # [] duplicated entries
    overflow: torch.Tensor       # [] Gaussians whose rect was truncated


def _f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in the total order of f32 values (-0 before +0, +inf last)."""
    bits = x.contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)


def bin_gaussians(pre: PreprocessOutput, grid_x: int, grid_y: int,
                  max_tiles_per_gaussian: int, sort_mode: str = "quantized") -> BinningResult:
    """Depth-sorted per-tile Gaussian lists over N * max_tiles_per_gaussian
    slots.

    sort_mode "quantized": one key [tile | top depth bits] (the bits of a
    positive f32 are monotone in it), ties in the truncated depth in slot
    order; "exact": (tile, full f32 depth) lexicographically, as one
    combined 64-bit key."""
    n = pre.depth.shape[0]
    d_max = max_tiles_per_gaussian
    num_tiles = grid_x * grid_y
    dev = pre.depth.device

    rect_w = torch.clamp_min(pre.rect_max[:, 0] - pre.rect_min[:, 0], 1)
    slots = torch.arange(d_max, dtype=torch.int32, device=dev)
    # slot d covers tile (rect_min + (d % w, d // w)), row-major like
    # duplicateWithKeys' nested loop
    ty = pre.rect_min[:, 1:2] + slots[None, :] // rect_w[:, None]
    tx = pre.rect_min[:, 0:1] + slots[None, :] % rect_w[:, None]
    tile_id = ty * grid_x + tx                                           # [N, D]
    dup_valid = (slots[None, :] < pre.tiles_touched[:, None]) & pre.valid[:, None]
    tile_flat = torch.where(dup_valid, tile_id, num_tiles).to(torch.int64).reshape(-1)
    gidx_flat = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(d_max)

    if sort_mode == "quantized":
        tile_bits = max(int(num_tiles + 1).bit_length(), 1)
        depth_bits = 32 - tile_bits
        dbits = (torch.clamp_min(pre.depth, 0.0).contiguous().view(torch.int32).long()
                 >> (31 - depth_bits))
        dq = torch.clamp_max(dbits, (1 << depth_bits) - 1)
        # the JAX package's u32 key, held in int64
        key = (tile_flat << depth_bits) | dq.repeat_interleave(d_max)
        sorted_key, order = torch.sort(key, stable=True)
        bounds = torch.arange(num_tiles + 1, dtype=torch.int64, device=dev) << depth_bits
        tile_starts = torch.searchsorted(sorted_key, bounds, side="left").to(torch.int32)
    elif sort_mode == "exact":
        depth_key = torch.where(dup_valid, pre.depth[:, None], torch.inf).reshape(-1)
        key = (tile_flat << 32) | (_f32_order_key(depth_key) + 2 ** 31)
        _sk, order = torch.sort(key, stable=True)
        tile_starts = torch.searchsorted(
            tile_flat[order], torch.arange(num_tiles + 1, dtype=torch.int64, device=dev),
            side="left").to(torch.int32)
    else:
        raise ValueError(f"unknown sort_mode {sort_mode}")

    tile_counts = (tile_starts[1:] - tile_starts[:-1]).to(torch.int32)
    num_rendered = torch.sum(torch.clamp_max(pre.tiles_touched, d_max))
    overflow = torch.sum(pre.tiles_touched > d_max)
    return BinningResult(gidx_flat[order], tile_starts, tile_counts, num_rendered, overflow)
