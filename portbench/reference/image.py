"""Image resampling and SSIM for the reference, in plain PyTorch.

`scale_and_translate` is `jax.image.scale_and_translate` with the linear
(triangle) kernel, which the method's uncertainty model uses to fit an
image into its 336x336 canvas and to map results back: output sample j of
an axis reads the input at (j + 0.5) / scale - translation / scale - 0.5
through the triangle kernel, widened by 1 / scale when antialiasing a
downsample; each output's weights are normalised and it is zero when it
falls outside the input. SSIM is the usual 11x11 Gaussian window (sigma
1.5), zero padded, C1 = 0.01^2, C2 = 0.03^2.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F


def _weights(n_in: int, n_out: int, inv_scale: float, shift: float, antialias: bool,
             device) -> torch.Tensor:
    kernel = max(inv_scale, 1.0) if antialias else 1.0
    f64 = dict(dtype=torch.float64, device=device)
    sample = (torch.arange(n_out, **f64) + 0.5) * inv_scale - shift - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f64)[:, None]).abs() / kernel
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total > 1000 * np.finfo(np.float32).eps,
                    w / torch.where(total > 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(torch.float32)


def scale_and_translate(img: torch.Tensor, out_hw, scale_hw, antialias: bool) -> torch.Tensor:
    """img [H, W, C] -> [out_h, out_w, C]; output (y, x) reads input
    (y / scale_h, x / scale_w)."""
    out = img
    for axis, (n_out, s) in enumerate(zip(out_hw, scale_hw)):
        w = _weights(out.shape[axis], n_out, 1.0 / float(s), 0.0, antialias, img.device)
        out = torch.matmul(out.movedim(axis, -1), w).movedim(-1, axis)
    return out


def resize(img: torch.Tensor, out_hw) -> torch.Tensor:
    """`jax.image.resize(method="linear")` of the two leading axes."""
    return scale_and_translate(img, out_hw, [o / i for o, i in zip(out_hw, img.shape[:2])], True)


def letterbox_scale(canvas: int, valid_h: float, valid_w: float) -> float:
    """One scale for both axes: the valid region fitted into the square
    canvas, aspect kept (computed in float32, as an image size is)."""
    c = np.float32(canvas)
    return float(min(c / np.float32(valid_h), c / np.float32(valid_w)))


def into_canvas(img: torch.Tensor, canvas: int, valid_h: float, valid_w: float) -> torch.Tensor:
    """The [0, valid_h) x [0, valid_w) region of img [H, W, C], letterboxed
    into the top left of a canvas x canvas image (antialiased)."""
    s = letterbox_scale(canvas, valid_h, valid_w)
    return scale_and_translate(img, (canvas, canvas), (s, s), True)


def out_of_canvas(img: torch.Tensor, out_h: int, out_w: int, valid_h: float,
                  valid_w: float) -> torch.Tensor:
    """The inverse map: the canvas content back onto the valid region of an
    out_h x out_w image (bilinear)."""
    s = letterbox_scale(img.shape[0], valid_h, valid_w)
    inv = float(np.float32(1.0) / np.float32(s))
    return scale_and_translate(img, (out_h, out_w), (inv, inv), False)


def content_mask(canvas: int, valid_h: float, valid_w: float, cell: int, device) -> torch.Tensor:
    """[canvas / cell]^2 0/1 mask of the cells whose centre lies in the
    letterboxed content."""
    s = letterbox_scale(canvas, valid_h, valid_w)
    ch = float(np.float32(valid_h) * np.float32(s))
    cw = float(np.float32(valid_w) * np.float32(s))
    centres = (torch.arange(canvas // cell, dtype=torch.float32, device=device) + 0.5) * cell
    return ((centres[:, None] <= ch) & (centres[None, :] <= cw)).to(torch.float32)


def _window(device) -> torch.Tensor:
    g = torch.tensor([math.exp(-((i - 5) ** 2) / (2 * 1.5 ** 2)) for i in range(11)],
                     dtype=torch.float64)
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(torch.float32).to(device)


def ssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM of [H, W, 3] images, the mean over the channels [H, W]."""
    k = _window(x.device)[None, None].expand(3, 1, 11, 11)

    def filt(v):
        return F.conv2d(v.permute(2, 0, 1)[None], k, padding=5, groups=3)[0]
    mx, my = filt(x), filt(y)
    sxx = filt(x * x) - mx * mx
    syy = filt(y * y) - my * my
    sxy = filt(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sxx + syy + c2))
    return s.mean(0)
