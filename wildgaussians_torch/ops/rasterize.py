"""Truncation accounting of the rasterizer.

Counterpart of `overflow_count` in `wildgaussians_tpu/ops/rasterize.py`
(the pallas backend). The JAX package recounts the sort engine's visible
cells here and lets XLA merge that with the engine's own count; the port
takes the sort engine's count (`SortedTable.vis_count`). The partition
engine bins raw rect cells, so its big Gaussians are counted on the raw
`tiles_touched`.
"""
from typing import Optional

import torch


def overflow_count(tiles_touched: torch.Tensor, vis_count: Optional[torch.Tensor],
                   max_tiles_per_gaussian: int, *, d_small: int = 4,
                   big_fraction: float = 0.16, binning: str = "sort",
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated-contribution count: (a) Gaussians whose tile rect exceeds
    max_tiles_per_gaussian and (b) big Gaussians beyond the big-pool
    capacity, which keep only their cheap slots. tiles_touched [n] is
    preprocess's uncapped count.

    d_small is the engine's own (for "partition" the floored
    `partition_engine.engine_d_small`, as the caller passed it to the
    engine). binning "sort": a big Gaussian has more than d_small visible
    cells (vis_count [n], the visible cells among the first
    max_tiles_per_gaussian). "partition": more than d_small raw rect cells
    among the valid Gaussians (valid [n]); vis_count is unused."""
    overflow = torch.sum(tiles_touched > max_tiles_per_gaussian)
    if max_tiles_per_gaussian > d_small:
        m_cap = max(int(tiles_touched.shape[0] * big_fraction), 8)
        if binning == "partition":
            n_big = torch.sum((tiles_touched > d_small) & valid)
        else:
            n_big = torch.sum(vis_count > d_small)
        overflow = overflow + torch.clamp_min(n_big - m_cap, 0)
    return overflow
