"""Differentiable SSIM on [.., H, W, C] images.

Counterpart of `ssim` and `_depthwise_filter` in
`wildgaussians_tpu/ops/ssim.py`: an 11x11 Gaussian window (sigma 1.5) as two
separable zero-padded depthwise 1-D convolutions, C1 = 0.01^2,
C2 = 0.03^2. The JAX package keeps channels last; so do this module's
arguments (the convolutions run on a channels-first view). Plain torch
`conv2d`: the JAX package left these to XLA too. Compare on the card with
`torch.backends.cudnn.allow_tf32 = False`: cuDNN's default TF32 keeps ~3
decimal digits.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_filter(img: torch.Tensor, window_size: int = 11,
                      sigma: float = 1.5) -> torch.Tensor:
    """Zero-padded depthwise 2D Gaussian filter on [B,H,W,C] (two separable
    1-D passes: along H, then along W)."""
    c = img.shape[-1]
    g = torch.as_tensor(_gaussian_1d(window_size, sigma), device=img.device)
    pad = window_size // 2
    x = img.permute(0, 3, 1, 2)                                   # [B,C,H,W]
    x = F.conv2d(x, g.view(1, 1, window_size, 1).expand(c, 1, window_size, 1),
                 padding=(pad, 0), groups=c)
    x = F.conv2d(x, g.view(1, 1, 1, window_size).expand(c, 1, 1, window_size),
                 padding=(0, pad), groups=c)
    return x.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of [.,H,W,C] images; size_average=False gives the per-pixel map
    [.,H,W] (mean over channels)."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
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
