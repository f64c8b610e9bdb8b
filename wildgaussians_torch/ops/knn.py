"""Mean squared distance to the 3 nearest neighbors (init-time statistic).

Counterpart of `wildgaussians_tpu/ops/knn.py` (`mean_knn_dist2`, :38):
Morton-sort the points and search a +/-window band of the sorted order for
each point's k nearest neighbors. Plain torch on the caller's device; it
seeds the initial log-scales, so exactness is not required.
"""
import torch

_CHUNK = 1 << 16   # points per [chunk, 2 window] candidate block


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (Morton encoding), in int64."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """10-bit-per-axis Morton codes [N] int64."""
    mn = points.min(dim=0).values
    mx = points.max(dim=0).values
    rel = (points - mn) / torch.clamp_min(mx - mn, 1e-12)
    q = torch.clamp(rel * 1023.0, 0, 1023).to(torch.int64)
    return (_expand_bits_10(q[:, 0])
            | (_expand_bits_10(q[:, 1]) << 1)
            | (_expand_bits_10(q[:, 2]) << 2))


@torch.no_grad()
def mean_knn_dist2(points: torch.Tensor, window: int = 48, k: int = 3) -> torch.Tensor:
    """[N,3] -> [N] mean of squared distances to the k nearest neighbors,
    searched within a +/-window band of the (stable) Morton order."""
    n = points.shape[0]
    dev = points.device
    order = torch.sort(morton_codes(points), stable=True).indices
    sorted_pts = points[order]
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    out_sorted = torch.empty((n,), dtype=points.dtype, device=dev)
    for c0 in range(0, n, _CHUNK):
        i = torch.arange(c0, min(c0 + _CHUNK, n), device=dev)
        raw = i[:, None] + offsets[None, :]
        idx = torch.clamp(raw, 0, n - 1)
        d2 = ((sorted_pts[idx] - sorted_pts[i][:, None, :]) ** 2).sum(-1)
        # boundary-clipped slots duplicate real candidates: exclude them
        d2 = torch.where((idx == i[:, None]) | (raw != idx), torch.inf, d2)
        out_sorted[i] = torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted
    return out
