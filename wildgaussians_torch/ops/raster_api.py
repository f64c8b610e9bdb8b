"""Drop-in mirror of the reference rasterizer's object API.

Counterpart of `wildgaussians_tpu/ops/raster_api.py`: the reference's
`GaussianRasterizationSettings` + `GaussianRasterizer`
(diff_gaussian_rasterization/__init__.py:175-241) over the port's
`rasterize_gaussians`. As in the reference:

- the settings hold TRANSPOSED (row-vector) view and projection matrices;
  the adapter transposes them back to the port's column-vector
  CameraParams;
- means2D is a zeros tensor with requires_grad whose `.grad` receives the
  screen-space gradient of the means (the renderer's mean2d hook);
- the outputs are (color [3,H,W], radii [N], accumulation [H,W]).

The functional `rasterize_gaussians` (ops/rasterize.py) remains the native
API; this adapter exists for surface parity.
"""
import math
from typing import NamedTuple, Optional

import torch

from ..cameras import CameraParams
from .rasterize import mark_visible, rasterize_gaussians
from .sh import eval_sh_switch


class GaussianRasterizationSettings(NamedTuple):
    """Field-for-field mirror of the reference's settings."""
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    kernel_size: float
    subpixel_offset: Optional[torch.Tensor]   # only zeros/None supported
    bg: torch.Tensor                          # [3]
    scale_modifier: float
    viewmatrix: torch.Tensor                  # [4,4] TRANSPOSED world-to-camera
    projmatrix: torch.Tensor                  # [4,4] TRANSPOSED full projection
    sh_degree: int
    campos: torch.Tensor                      # [3]
    prefiltered: bool
    debug: bool
    return_accumulation: bool = True


def _camera_from_settings(s: GaussianRasterizationSettings) -> CameraParams:
    w, h = int(s.image_width), int(s.image_height)
    fx = w / (2.0 * float(s.tanfovx))
    fy = h / (2.0 * float(s.tanfovy))
    view = torch.as_tensor(s.viewmatrix, dtype=torch.float32)
    dev = view.device
    return CameraParams(
        viewmatrix=view.T,
        projmatrix=torch.as_tensor(s.projmatrix, dtype=torch.float32, device=dev).T,
        campos=torch.as_tensor(s.campos, dtype=torch.float32, device=dev),
        intrinsics=torch.tensor([fx, fy, w / 2.0, h / 2.0], dtype=torch.float32, device=dev),
        tan_fov=torch.tensor([float(s.tanfovx), float(s.tanfovy)], dtype=torch.float32,
                             device=dev))


class GaussianRasterizer:
    """Mirror of the reference GaussianRasterizer."""

    def __init__(self, raster_settings: GaussianRasterizationSettings):
        self.raster_settings = raster_settings
        if raster_settings.prefiltered:
            raise NotImplementedError("prefiltered=True is not supported "
                                      "(the reference kernels ignore it too)")
        sp = raster_settings.subpixel_offset
        if sp is not None and bool(torch.any(torch.as_tensor(sp) != 0)):
            raise NotImplementedError("nonzero subpixel_offset not supported")

    def markVisible(self, positions: torch.Tensor) -> torch.Tensor:
        """Frustum culling mask (the reference's markVisible)."""
        return mark_visible(positions, _camera_from_settings(self.raster_settings))

    def __call__(self, means3D, means2D, opacities, shs=None, colors_precomp=None, scales=None,
                 rotations=None, cov3D_precomp=None, **raster_kwargs):
        """The reference forward: exactly one of shs / colors_precomp and
        exactly one of (scales, rotations) / cov3D_precomp. Returns (color
        [3,H,W], radii [N], accumulation [H,W]). `raster_kwargs` pass
        through to rasterize_gaussians (backend=..., max_tiles_per_gaussian=...)."""
        s = self.raster_settings
        if (shs is None) == (colors_precomp is None):
            raise ValueError("Please provide exactly one of either SHs or precomputed colors!")
        has_sr = scales is not None or rotations is not None
        if has_sr == (cov3D_precomp is not None):
            raise ValueError("Please provide exactly one of either scale/rotation pair or "
                             "precomputed 3D covariance!")
        camera = _camera_from_settings(s)
        camera = camera._replace(**{k: v.to(means3D.device) for k, v in camera._asdict().items()})
        n = means3D.shape[0]
        if colors_precomp is None:
            # the reference's computeColorFromSH: view directions from the
            # camera centre, clamped at 0 after the +0.5 offset
            dirs = means3D - camera.campos[None]
            dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
            shs_t = shs.to(torch.float32).transpose(1, 2)                 # [N,3,K]
            max_deg = math.isqrt(shs.shape[1]) - 1
            colors_precomp = torch.clamp_min(
                eval_sh_switch(int(s.sh_degree), max_deg, shs_t, dirs) + 0.5, 0.0)
        if scales is None:
            scales = torch.ones((n, 3), dtype=torch.float32, device=means3D.device)
            rotations = torch.cat([torch.ones((n, 1), device=means3D.device),
                                   torch.zeros((n, 3), device=means3D.device)], dim=1)
        out = rasterize_gaussians(
            means3D, scales, rotations, opacities.reshape(n), colors_precomp, camera,
            int(s.image_width), int(s.image_height), kernel_size=float(s.kernel_size),
            bg=torch.as_tensor(s.bg, dtype=torch.float32, device=means3D.device),
            scale_modifier=float(s.scale_modifier),
            cov3d=(None if cov3D_precomp is None
                   else torch.as_tensor(cov3D_precomp, dtype=torch.float32)),
            mean2d_hook=means2D, **raster_kwargs)
        return out.color.permute(2, 0, 1), out.radii, 1.0 - out.final_T

    # the nn.Module-style name
    forward = __call__
