"""Mean squared distance to the 3 nearest neighbors (init-time statistic).

Counterpart of the JAX trainer's default k-NN, the native simple-knn
(`native/simple_knn.cpp`, loaded by `wildgaussians_tpu/ops/knn_native.py`):
the JAX trainer seeds its scales from it whenever g++ can build it
(`wildgaussians_tpu/models/wildgaussians.py:194-199`), and falls back to
`wildgaussians_tpu/ops/knn.py` only where it cannot. Morton-sort the points
(ties by index) and search a +/-window band of the sorted order for each
point's k nearest neighbors. The Morton cell is quantised as the native
code does it, `(p - min) * (1023 / range)`: the fallback's
`((p - min) / range) * 1023` rounds a few points into another cell, which
moves the Morton order and with it the neighbors the window finds. Plain
torch on the caller's device.
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
    """10-bit-per-axis Morton codes [N] int64, quantised as
    `native/simple_knn.cpp` (:62-76) does: the cell is (p - min) * inv,
    inv = 1023 / range (0 where range <= 1e-12), clamped to [0, 1023] and
    truncated."""
    mn = points.min(dim=0).values
    rng = points.max(dim=0).values - mn
    # a true division: torch computes `1023.0 / rng` as rng.reciprocal() * 1023,
    # one ulp off the native code's quotient, which moves points between cells
    inv = torch.where(rng > 1e-12, torch.full_like(rng, 1023.0) / rng, torch.zeros_like(rng))
    q = torch.clamp((points - mn) * inv, 0, 1023).to(torch.int64)
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
