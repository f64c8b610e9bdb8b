"""Per-Gaussian projective preprocess: cov3D, EWA cov2D, conic, radii, tiles.

Counterpart of `wildgaussians_tpu/ops/gaussians.py`, with the same operation
order: the integer outputs (tile rects, radii, validity) decide which tile
entries exist, so a one-ulp difference in the float chain could move a rect
edge and reorder the sort engine's table.
"""
from typing import NamedTuple, Optional

import torch

from ..cameras import CameraParams


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) [..., 4] -> rotation matrix [..., 3, 3]. Does not
    normalize: the caller's activation does."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space 3D covariance R S S^T R^T, packed symmetric
    [..., 6] = (xx, xy, xz, yy, yz, zz)."""
    R = quat_to_rotmat(rotations)
    s2 = torch.square(scales * scale_modifier)

    def sig(i, j):
        return (R[..., i, 0] * s2[..., 0] * R[..., j, 0]
                + R[..., i, 1] * s2[..., 1] * R[..., j, 1]
                + R[..., i, 2] * s2[..., 2] * R[..., j, 2])
    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2),
                        sig(1, 1), sig(1, 2), sig(2, 2)], dim=-1)


def _rowdot3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k] * w[k], summed left to right."""
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor, camera: CameraParams,
                  kernel_size: float):
    """EWA screen-space covariance with mip-splatting dilation.

    Returns (cov2d [...,3] = (a, b, c) with +kernel_size on the diagonal,
    coef [...]): coef = sqrt(det0/(det1+1e-6)+1e-6), zeroed when either
    det <= 1e-6.
    """
    fx, fy = camera.intrinsics[0], camera.intrinsics[1]
    tan_fovx, tan_fovy = camera.tan_fov[0], camera.tan_fov[1]
    W = camera.viewmatrix[:3, :3]  # world->camera rotation

    t = torch.stack([_rowdot3(means3d, W[i]) for i in range(3)], dim=-1) + camera.viewmatrix[:3, 3]
    tz = t[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = torch.minimum(torch.maximum(t[..., 0] / tz, -limx), limx) * tz
    tytz = torch.minimum(torch.maximum(t[..., 1] / tz, -limy), limy) * tz

    # J = d(img)/d(cam): [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2

    # T = J @ W (2x3); cov2d = T @ Vrk @ T^T
    t0 = j00[..., None] * W[0] + j02[..., None] * W[2]   # [...,3]
    t1 = j11[..., None] * W[1] + j12[..., None] * W[2]   # [...,3]

    cxx, cxy, cxz = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    cyy, cyz, czz = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]

    def vrk_mul(v):  # Vrk @ v for packed symmetric Vrk
        return torch.stack([
            cxx * v[..., 0] + cxy * v[..., 1] + cxz * v[..., 2],
            cxy * v[..., 0] + cyy * v[..., 1] + cyz * v[..., 2],
            cxz * v[..., 0] + cyz * v[..., 1] + czz * v[..., 2],
        ], dim=-1)

    def dot3(u, v):
        return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]

    vt0 = vrk_mul(t0)
    vt1 = vrk_mul(t1)
    a = dot3(t0, vt0)
    b = dot3(t0, vt1)
    c = dot3(t1, vt1)

    det0 = torch.clamp_min(a * c - b * b, 1e-6)
    det1 = torch.clamp_min((a + kernel_size) * (c + kernel_size) - b * b, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    raw_det0 = a * c - b * b
    raw_det1 = (a + kernel_size) * (c + kernel_size) - b * b
    coef = torch.where((raw_det0 <= 1e-6) | (raw_det1 <= 1e-6), 0.0, coef)

    cov2d = torch.stack([a + kernel_size, b, c + kernel_size], dim=-1)
    return cov2d, coef


def project_points(means3d: torch.Tensor, camera: CameraParams):
    """Project world points. Returns (ndc_xy [...,2], depth [...]); the
    homogeneous divide is by (w + 1e-7), as in the reference rasterizer."""
    P = camera.projmatrix

    def hom(row):
        return means3d[..., 0] * row[0] + means3d[..., 1] * row[1] + means3d[..., 2] * row[2] + row[3]
    p_hom = torch.stack([hom(P[i]) for i in range(4)], dim=-1)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    ndc_xy = p_hom[..., :2] * p_w[..., None]
    depth = hom(camera.viewmatrix[2])
    return ndc_xy, depth


def ndc_to_pixel(ndc_xy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    size = torch.tensor([width, height], dtype=ndc_xy.dtype, device=ndc_xy.device)
    return ((ndc_xy + 1.0) * size - 1.0) * 0.5


class PreprocessOutput(NamedTuple):
    mean2d: torch.Tensor        # [N,2] pixel coordinates
    depth: torch.Tensor         # [N] view-space z
    conic: torch.Tensor         # [N,3] inverse cov2d (a,b,c)
    opacity: torch.Tensor       # [N] opacity * mip-splat coef
    radius: torch.Tensor        # [N] int32 screen-space radius (0 = culled)
    rect_min: torch.Tensor      # [N,2] int32 tile rect (inclusive start)
    rect_max: torch.Tensor      # [N,2] int32 tile rect (exclusive end)
    tiles_touched: torch.Tensor  # [N] int32
    valid: torch.Tensor         # [N] bool


def _trunc_clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(int32(x), 0, hi) with int32(x) truncating toward zero and
    saturating, NaN -> 0 (XLA's float->int convert). A plain `.to(int32)`
    of an out-of-range float is undefined, so clamp in float first: for
    finite x, trunc(clamp(x, -1, hi)) clipped to [0, hi] is the same."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(torch.clamp(x, -1.0, float(hi)).to(torch.int32), 0, hi)


def preprocess(means3d: torch.Tensor,
               cov3d: torch.Tensor,
               opacities: torch.Tensor,
               camera: CameraParams,
               width: int, height: int,
               kernel_size: float,
               tile_size: int = 16,
               alive: Optional[torch.Tensor] = None) -> PreprocessOutput:
    """Full per-Gaussian preprocess, vectorized. `opacities` is [N]
    post-activation; `alive` optionally masks dead slots of the store (they
    get radius 0 and no tiles)."""
    ndc_xy, depth = project_points(means3d, camera)
    mean2d = ndc_to_pixel(ndc_xy, width, height)

    cov2d, coef = compute_cov2d(means3d, cov3d, camera, kernel_size)
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    det_valid = det != 0.0
    det_inv = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0), 0.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))

    grid_x = (width + tile_size - 1) // tile_size
    grid_y = (height + tile_size - 1) // tile_size
    # getRect: truncate toward zero, clamp to the grid
    rmin_x = _trunc_clip((mean2d[..., 0] - radius_f) / tile_size, grid_x)
    rmin_y = _trunc_clip((mean2d[..., 1] - radius_f) / tile_size, grid_y)
    rmax_x = _trunc_clip((mean2d[..., 0] + radius_f + tile_size - 1) / tile_size, grid_x)
    rmax_y = _trunc_clip((mean2d[..., 1] + radius_f + tile_size - 1) / tile_size, grid_y)
    tiles = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = (depth > 0.2) & det_valid & (tiles > 0)
    if alive is not None:
        valid = valid & alive

    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    tiles = torch.where(valid, tiles, 0)
    return PreprocessOutput(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=opacities * coef,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles,
        valid=valid,
    )


def apply_3d_filter(raw_scales: torch.Tensor, raw_opacities: torch.Tensor,
                    filter_3d: torch.Tensor):
    """Fuse the mip-splatting 3D filter into scales/opacities:
      scales' = sqrt(scales^2 + filter^2)
      opacity' = opacity * sqrt(prod(scales^2) / prod(scales^2 + filter^2))
    `raw_scales` are post-exp, `raw_opacities` post-sigmoid, filter_3d [N,1].
    """
    s2 = torch.square(raw_scales)
    f2 = torch.square(filter_3d)
    s2f = s2 + f2
    scales = torch.sqrt(s2f)
    det1 = s2[..., 0] * s2[..., 1] * s2[..., 2]
    det2 = s2f[..., 0] * s2f[..., 1] * s2f[..., 2]
    # floor guards dead/padded slots (scales == filter == 0) against 0/0
    coef = torch.sqrt(det1 / torch.clamp_min(det2, 1e-30))
    return scales, raw_opacities * coef[..., None]
