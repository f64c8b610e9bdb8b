"""Blend constants and the 16x16 tile grid helpers.

Counterpart of the grid helpers of `wildgaussians_tpu/ops/rasterize_tiled.py`
(the tiled blend itself is not part of the serving path).
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class TileGrid(NamedTuple):
    width: int
    height: int
    tile_size: int
    grid_x: int
    grid_y: int

    @property
    def num_tiles(self):
        return self.grid_x * self.grid_y

    @property
    def pixels_per_tile(self):
        return self.tile_size * self.tile_size


def make_grid(width: int, height: int, tile_size: int = 16) -> TileGrid:
    return TileGrid(width, height, tile_size,
                    (width + tile_size - 1) // tile_size,
                    (height + tile_size - 1) // tile_size)


def tiles_to_image(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[T, P(, C)] -> [H, W(, C)] crop."""
    ts = grid.tile_size
    ch = tiles.shape[2:]
    x = tiles.reshape(grid.grid_y, grid.grid_x, ts, ts, *ch)
    x = torch.movedim(x, 2, 1).reshape(grid.grid_y * ts, grid.grid_x * ts, *ch)
    return x[:grid.height, :grid.width]


def image_to_tiles(img: torch.Tensor, grid: TileGrid, fill=0.0) -> torch.Tensor:
    """[H, W(, C)] -> [T, P(, C)] with padding."""
    ts = grid.tile_size
    ch = img.shape[2:]
    ph, pw = grid.grid_y * ts, grid.grid_x * ts
    # F.pad takes (last dim lo, hi, ..., first dim lo, hi)
    pad = [0, 0] * len(ch) + [0, pw - img.shape[1], 0, ph - img.shape[0]]
    img = F.pad(img, pad, value=fill)
    x = img.reshape(grid.grid_y, ts, grid.grid_x, ts, *ch)
    x = torch.movedim(x, 1, 2).reshape(grid.num_tiles, ts * ts, *ch)
    return x
