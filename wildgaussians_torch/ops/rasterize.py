"""Truncation accounting of the sort-engine rasterizer.

Counterpart of the sort-engine branch of `overflow_count` in
`wildgaussians_tpu/ops/rasterize.py`. The JAX package recounts the visible
cells here and lets XLA merge that with the sort engine's own count; the
port takes the sort engine's count (`SortedTable.vis_count`).
"""
import torch


def overflow_count(tiles_touched: torch.Tensor, vis_count: torch.Tensor,
                   max_tiles_per_gaussian: int, *, d_small: int = 4,
                   big_fraction: float = 0.16) -> torch.Tensor:
    """Truncated-contribution count: (a) Gaussians whose tile rect exceeds
    max_tiles_per_gaussian and (b) big Gaussians (more than d_small visible
    cells) beyond the big-pool capacity, which keep only their d_small cheap
    slots. tiles_touched [n] is preprocess's uncapped count; vis_count [n]
    the visible cells among the first max_tiles_per_gaussian."""
    overflow = torch.sum(tiles_touched > max_tiles_per_gaussian)
    if max_tiles_per_gaussian > d_small:
        m_cap = max(int(tiles_touched.shape[0] * big_fraction), 8)
        n_big = torch.sum(vis_count > d_small)
        overflow = overflow + torch.clamp_min(n_big - m_cap, 0)
    return overflow
