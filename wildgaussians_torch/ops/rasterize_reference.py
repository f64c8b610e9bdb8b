"""The slow, plainly correct rasterizer: the port's oracle of every blend.

Counterpart of `wildgaussians_tpu/ops/rasterize_reference.py`. It keeps the
reference CUDA tile renderer's compositing semantics (forward.cu:273-395):
front-to-back alpha blending in depth order with the power > 0 skip, the
0.99 alpha cap, the 1/255 alpha floor, the T < 1e-4 sticky stop (the
crossing entry excluded), and the per-tile rect membership test (a
Gaussian touches only the pixels whose tile lies in its projected rect).
Compositing runs in its associative form: within each depth-ordered chunk
of Gaussians, log(1 - alpha) is prefix-summed along the chunk and the
transmittances are exp() of the prefixes, the sequential product up to
rounding. Gradients come from autograd. O(N H W): tests and small scenes
only.
"""
import torch

from .rasterize_tiled import ALPHA_MAX, ALPHA_MIN, T_EPS


def _blend_chunk(C, T, done, mean2d, conic, opacity, colors, valid, rect_min, rect_max,
                 pix_x, pix_y, tile_x, tile_y):
    """One depth-ordered chunk of K Gaussians composited over all pixels:
    (C [H,W,3], T [H,W], done [H,W]) -> the same after the chunk."""
    dx = mean2d[:, 0, None, None] - pix_x[None]                        # [K,H,W]
    dy = mean2d[:, 1, None, None] - pix_y[None]
    power = (-0.5 * (conic[:, 0, None, None] * dx * dx + conic[:, 2, None, None] * dy * dy)
             - conic[:, 1, None, None] * dx * dy)
    alpha = torch.clamp_max(opacity[:, None, None] * torch.exp(power), ALPHA_MAX)
    in_rect = ((tile_x[None] >= rect_min[:, 0, None, None])
               & (tile_x[None] < rect_max[:, 0, None, None])
               & (tile_y[None] >= rect_min[:, 1, None, None])
               & (tile_y[None] < rect_max[:, 1, None, None]))
    use = valid[:, None, None] & in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)

    log1ma = torch.where(use, torch.log1p(-torch.where(use, alpha, 0.0)), 0.0)
    S = torch.cumsum(log1ma, dim=0)                  # inclusive prefix
    T_at = T[None] * torch.exp(S - log1ma)           # exclusive prefix transmittance
    # sticky stop: T exp(S) < T_EPS is monotone within the chunk
    t_inc = T[None] * torch.exp(S)
    contrib = use & ~done[None] & (t_inc >= T_EPS)
    w = torch.where(contrib, alpha * T_at, 0.0)
    C = C + torch.einsum("khw,kc->hwc", w, colors)
    T_new = T * torch.exp(torch.where(contrib, log1ma, 0.0).sum(0))
    done_new = done | (t_inc < T_EPS).any(0)
    return C, T_new, done_new


def rasterize_reference(mean2d, depth, conic, opacity, colors, valid, rect_min, rect_max, *,
                        width: int, height: int, bg=None, tile_size: int = 16, chunk: int = 64):
    """Oracle rasterization of the preprocess fields and per-Gaussian colors
    [N, 3]. Returns (color [H,W,3], final_T [H,W]); differentiable in
    mean2d, conic, opacity, colors and bg."""
    dev = mean2d.device
    order = torch.argsort(torch.where(valid, depth, torch.inf), stable=True)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")
    tile_x = (pix_x / tile_size).to(torch.int32)
    tile_y = (pix_y / tile_size).to(torch.int32)
    C = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for s in range(0, order.shape[0], chunk):
        g = order[s:s + chunk]
        C, T, done = _blend_chunk(C, T, done, mean2d[g], conic[g], opacity[g], colors[g],
                                  valid[g], rect_min[g], rect_max[g], pix_x, pix_y,
                                  tile_x, tile_y)
    if bg is not None:
        C = C + T[..., None] * bg[None, None, :]
    return C, T
