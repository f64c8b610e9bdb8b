"""Differentiable SSIM, MS-SSIM and the DSSIM variants on [.., H, W, C]
images.

Counterpart of `wildgaussians_tpu/ops/ssim.py`: an 11x11 Gaussian window
(sigma 1.5) as two separable zero-padded depthwise 1-D convolutions,
C1 = 0.01^2, C2 = 0.03^2, C3 = C2 / 2; `ssim`, `dssim_go` (NeRF on-the-go's
DSSIM), `msssim` and `ssim_down` (the uncertainty model's), with the
resizes of `ops/image.py`. The JAX package keeps channels last; so do this
module's arguments (the convolutions run on a channels-first view). Plain
torch `conv2d`: the JAX package left these to XLA too, at
`Precision.HIGHEST`; the port's entry points run them under
`device.full_f32`, since cuDNN's default TF32 keeps ~3 decimal digits.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .image import resize


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The normalised 1-D window on `device`, copied there once (a copy
    from the host would make every call wait on the device)."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _depthwise_filter(img: torch.Tensor, window_size: int = 11,
                      sigma: float = 1.5) -> torch.Tensor:
    """Zero-padded depthwise 2D Gaussian filter on [B,H,W,C] (two separable
    1-D passes: along H, then along W)."""
    c = img.shape[-1]
    g = _gaussian_1d(window_size, sigma, img.device)
    pad = window_size // 2
    x = img.permute(0, 3, 1, 2)                                   # [B,C,H,W]
    x = F.conv2d(x, g.view(1, 1, window_size, 1).expand(c, 1, window_size, 1),
                 padding=(pad, 0), groups=c)
    x = F.conv2d(x, g.view(1, 1, 1, window_size).expand(c, 1, 1, window_size),
                 padding=(0, pad), groups=c)
    return x.permute(0, 2, 3, 1)


def _ensure_batch(img: torch.Tensor):
    return (img[None], True) if img.dim() == 3 else (img, False)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of [.,H,W,C] images; size_average=False gives the per-pixel map
    [.,H,W] (mean over channels)."""
    img1, squeeze = _ensure_batch(img1)
    img2, _ = _ensure_batch(img2)
    mu1 = _depthwise_filter(img1, window_size)
    mu2 = _depthwise_filter(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_filter(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_filter(img1 * img2, window_size) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    out = ssim_map.mean(-1)
    return out[0] if squeeze else out


def _ssim_parts(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """(luminance, contrast, structure) maps of [B,H,W,C] images."""
    mu1 = _depthwise_filter(img1, window_size)
    mu2 = _depthwise_filter(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_filter(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_filter(img1 * img2, window_size) - mu1_mu2
    sigma1 = torch.sqrt(torch.clamp_min(sigma1_sq, 0))
    sigma2 = torch.sqrt(torch.clamp_min(sigma2_sq, 0))
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    C3 = C2 / 2
    luminance = (2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)
    contrast = (2 * sigma1 * sigma2 + C2) / (sigma1_sq + sigma2_sq + C2)
    structure = (sigma12 + C3) / (sigma1 * sigma2 + C3)
    return luminance, contrast, structure


def dssim_go(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             size_average: bool = True) -> torch.Tensor:
    """NeRF on-the-go's DSSIM: (1 - l)(1 - c)(1 - s), the mean or (with
    size_average=False) the per-pixel map [.,H,W] (mean over channels)."""
    img1, squeeze = _ensure_batch(img1)
    img2, _ = _ensure_batch(img2)
    lum, con, stru = _ssim_parts(img1, img2, window_size)
    dssim_map = (1 - lum) * (1 - con) * (1 - stru)
    if size_average:
        return dssim_map.mean()
    out = dssim_map.mean(-1)
    return out[0] if squeeze else out


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, on [B,H,W,C]; an odd last row or column
    is dropped (reduce_window "VALID")."""
    b, h, w, c = img.shape
    x = img[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c)
    return x.sum(dim=(2, 4)) / 4.0


def _resize_bilinear(img: torch.Tensor, size) -> torch.Tensor:
    return resize(img, (img.shape[0], size[0], size[1], img.shape[-1]))


def _resize_area(img: torch.Tensor, size) -> torch.Tensor:
    return resize(img, (img.shape[0], size[0], size[1], img.shape[-1]), antialias=True)


def msssim(x: torch.Tensor, y: torch.Tensor, max_size=None, min_size: int = 200) -> torch.Tensor:
    """Multi-scale SSIM map [.,H,W]: the three parts at the base scale, then
    contrast and structure at each halved scale while both sides exceed
    `min_size`, resized back and multiplied; mean over channels."""
    x, squeeze = _ensure_batch(x)
    y, _ = _ensure_batch(y)
    raw_size = tuple(x.shape[1:3])
    if max_size is not None:
        scale_factor = min(1.0, max(max_size / x.shape[1], max_size / x.shape[2]))
        if scale_factor < 1.0:
            nh, nw = int(x.shape[1] * scale_factor), int(x.shape[2] * scale_factor)
            x, y = _resize_area(x, (nh, nw)), _resize_area(y, (nh, nw))
    maps = list(_ssim_parts(x, y))
    orig = tuple(x.shape[1:3])
    while x.shape[1] > min_size and x.shape[2] > min_size:
        x, y = _avg_pool2(x), _avg_pool2(y)
        maps.extend(_resize_bilinear(m, orig) for m in _ssim_parts(x, y)[1:])
    out = torch.prod(torch.stack(maps, -1), dim=-1)
    if max_size is not None and tuple(out.shape[1:3]) != raw_size:
        out = _resize_bilinear(out, raw_size)
    out = out.mean(-1)
    return out[0] if squeeze else out


def ssim_down(x: torch.Tensor, y: torch.Tensor, max_size=None) -> torch.Tensor:
    """The SSIM map [.,H,W] computed at most `max_size` on a side (area
    resize down), then resized back."""
    x, squeeze = _ensure_batch(x)
    y, _ = _ensure_batch(y)
    osize = tuple(x.shape[1:3])
    if max_size is not None:
        scale_factor = max(max_size / x.shape[1], max_size / x.shape[2])
        if scale_factor < 1.0:
            nh, nw = int(x.shape[1] * scale_factor), int(x.shape[2] * scale_factor)
            x, y = _resize_area(x, (nh, nw)), _resize_area(y, (nh, nw))
    out = ssim(x, y, size_average=False)
    if max_size is not None and tuple(out.shape[1:3]) != osize:
        out = resize(out, (out.shape[0], *osize))
    return out[0] if squeeze else out
