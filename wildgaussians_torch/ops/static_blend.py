"""The sort-once / blend-many static viewer path: the sort engine's table,
built once, and a forward-only blend with planar output, run per frame.

Counterpart of `_make_static_renderer` and `_make_static_fwd_call` in
`wildgaussians_tpu/ops/rasterize_pallas.py` (:1501, :1472), at the exact
f32 table (the JAX package's `pack16=False`). One kernel, with its plain
PyTorch version beside it:

  K4 `blend_forward_planar`  csrc/blend_fwd_planar.cu  K1 with planar output

The wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error). There is no fallback from one to the other.
"""
import ctypes
from typing import Callable, Optional, Tuple

import torch

from . import _build
from .blend import P_PIX, _check_tiles, blend_forward_plain, tile_order
from .rasterize_tiled import TileGrid
from .sort_engine import _build_sorted_table


def blend_forward_planar_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                               tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                               bg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4: K1's plain version (`blend_forward_plain`),
    rearranged to the planar [n_passes, 4, T, 256]: r, g, b with final_T bg
    added, then final_T."""
    colors, final_t = blend_forward_plain(table, tile_starts, tile_counts, grid, n_passes)[:2]
    rgb = colors.permute(0, 3, 1, 2) + final_t[None, None] * bg[None, :, None, None]
    return torch.cat([rgb, final_t[None, None].expand(n_passes, 1, -1, -1)], dim=1)


_PLANAR_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]


def _kernel():
    fn = _build.load("blend_fwd_planar").wg_blend_fwd_planar
    fn.argtypes = _PLANAR_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def blend_forward_planar(table: torch.Tensor, tile_starts: torch.Tensor,
                         tile_counts: torch.Tensor, grid: TileGrid, n_passes: int,
                         bg: torch.Tensor, order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: blend every tile's depth-sorted entries for 1-3 color passes into
    the planar [n_passes, 4, T, 256] (r, g, b with final_T bg added, then
    final_T). table [6 + 3 n_passes, N] f32 as K1's; bg [3] f32 on the
    table's device (read by the kernel: no host sync); order [T] int32 the
    order in which the kernel takes the tiles (`blend.tile_order`, computed
    here when None). A CPU table runs the plain version; a CUDA table
    launches the kernel in `csrc/blend_fwd_planar.cu` and adds one to
    `blend_forward_planar.launches`."""
    if table.device.type == "cpu":
        return blend_forward_planar_plain(table, tile_starts, tile_counts, grid, n_passes, bg)
    if table.device.type != "cuda":
        raise ValueError(f"blend_forward_planar: unsupported device {table.device}")
    T = grid.num_tiles
    if not 1 <= n_passes <= 3:
        raise ValueError(f"blend_forward_planar takes 1-3 color passes, got {n_passes}")
    if grid.tile_size != 16:
        raise ValueError("blend_forward_planar works on 16x16 tiles")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 6 + 3 * n_passes:
        raise ValueError(f"table must be f32 [{6 + 3 * n_passes}, N], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if table.stride(1) != 1:
        raise ValueError("table rows must be contiguous")
    _check_tiles("blend_forward_planar", table, tile_starts, tile_counts, order, T)
    if bg.dtype != torch.float32 or tuple(bg.shape) != (3,) or not bg.is_contiguous() \
            or bg.device != table.device:
        raise ValueError(f"bg must be a contiguous f32 [3] on {table.device}")
    if order is None:
        order = tile_order(tile_counts, T)
    out = torch.empty((n_passes, 4, T, P_PIX), dtype=torch.float32, device=table.device)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), tile_starts.data_ptr(),
                 tile_counts.data_ptr(), order.data_ptr(), T, grid.grid_x, n_passes,
                 bg.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd_planar kernel launch failed with CUDA error {err}")
    blend_forward_planar.launches += 1
    return out


blend_forward_planar.launches = 0


def _make_static_renderer(grid: TileGrid, K: int, n: int, d_max: int, n_passes: int = 1,
                          d_small: int = 4, big_fraction: float = 0.16
                          ) -> Tuple[Callable, Callable]:
    """Sort once, blend many times, for a static (scene, camera) pair.
    Returns (bin_fn, blend_fn):

      bin_fn(mean2d, conic, opacity, colors_stack, depth, rect_min, rect_max,
             tiles_touched, valid) -> (table, starts, counts, order), the sort
             engine's table (`_build_sorted_table`) of n Gaussians and the
             order in which K4 takes its tiles (`blend.tile_order`), computed
             once for every frame of the pose;
      blend_fn(table, starts, counts, bg, order) -> [n_passes, 4, T, 256]
             planar (r, g, b with final_T bg folded in, then final_T) from K4.

    Forward only. K must be the kernels' 256-entry chunk."""
    if K != 256:
        raise ValueError(f"the blend kernels walk 256-entry chunks, got chunk={K}")

    def bin_fn(mean2d, conic, opacity, colors_stack, depth, rect_min, rect_max,
               tiles_touched, valid):
        st = _build_sorted_table(grid, n, d_max, n_passes, d_small, big_fraction, mean2d,
                                 conic, opacity, colors_stack, depth, rect_min, rect_max,
                                 tiles_touched, valid)
        return st.table, st.tile_starts, st.tile_counts, tile_order(st.tile_counts,
                                                                   grid.num_tiles)

    def blend_fn(table, starts, counts, bg, order):
        return blend_forward_planar(table, starts, counts, grid, n_passes, bg, order)

    return bin_fn, blend_fn
