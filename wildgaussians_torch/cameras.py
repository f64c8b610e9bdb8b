"""Camera matrix math (host numpy and device torch).

Counterpart of `wildgaussians_tpu/cameras.py`. Conventions (OpenCV):
  - poses are camera-to-world [3,4], x right, y down, z forward
  - the view matrix is world-to-camera 4x4
  - pixel centers sit at integer coordinates
"""
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .types import Cameras


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


class CameraParams(NamedTuple):
    """Device-side camera: a few f32 tensors. Image width/height travel
    separately."""
    viewmatrix: torch.Tensor      # [4,4] world-to-camera
    projmatrix: torch.Tensor      # [4,4] full projection = P @ view
    campos: torch.Tensor          # [3] camera center in world
    intrinsics: torch.Tensor      # [4] fx, fy, cx, cy
    tan_fov: torch.Tensor         # [2] tan(fovx/2), tan(fovy/2)


def get_world2view(pose: np.ndarray) -> np.ndarray:
    """c2w [3,4] -> w2c [4,4] (inverse of the 4x4 c2w)."""
    pose4 = np.concatenate([pose, np.array([[0, 0, 0, 1]], dtype=pose.dtype)], axis=0)
    return np.linalg.inv(pose4).astype(np.float32)


def get_projection_matrix_opencv(w, h, fx, fy, cx, cy, znear=0.01, zfar=100.0) -> np.ndarray:
    """OpenCV-intrinsics projection."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * fx / w
    P[1, 1] = 2.0 * fy / h
    P[0, 2] = (2.0 * cx - w) / w
    P[1, 2] = (2.0 * cy - h) / h
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def make_camera_params(camera: Cameras, device="cpu") -> Tuple[CameraParams, int, int]:
    """Camera params for a single camera, built on the host. Returns
    (params, W, H)."""
    camera = camera.item()
    if camera.image_sizes is None:
        raise ValueError("camera has no image size")
    width, height = int(camera.image_sizes[0]), int(camera.image_sizes[1])
    fx, fy, cx, cy = [float(x) for x in camera.intrinsics]
    view = get_world2view(np.asarray(camera.poses, dtype=np.float64).astype(np.float32))
    proj = get_projection_matrix_opencv(width, height, fx, fy, cx, cy)
    full = (proj @ view).astype(np.float32)
    c2w4 = np.linalg.inv(view)
    campos = c2w4[:3, 3]
    tanfovx = math.tan(focal2fov(fx, width) * 0.5)
    tanfovy = math.tan(focal2fov(fy, height) * 0.5)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    params = CameraParams(
        viewmatrix=t(view),
        projmatrix=t(full),
        campos=t(campos),
        intrinsics=t([fx, fy, cx, cy]),
        tan_fov=t([tanfovx, tanfovy]),
    )
    return params, width, height


def make_camera_params_torch(pose: torch.Tensor, intrinsics: torch.Tensor,
                             width: int, height: int,
                             znear: float = 0.01, zfar: float = 100.0) -> CameraParams:
    """Camera matrices computed on the device from a [3,4] pose and [4]
    intrinsics (counterpart of `make_camera_params_jax`)."""
    pose = pose.to(torch.float32)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=pose.dtype, device=pose.device)
    view = torch.linalg.inv(torch.cat([pose, bottom], dim=0))
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    w, h = float(width), float(height)
    zero = torch.zeros((), dtype=torch.float32, device=pose.device)
    one = torch.ones((), dtype=torch.float32, device=pose.device)
    P = torch.stack([
        torch.stack([2.0 * fx / w, zero, (2.0 * cx - w) / w, zero]),
        torch.stack([zero, 2.0 * fy / h, (2.0 * cy - h) / h, zero]),
        torch.stack([zero, zero, zfar / (zfar - znear) * one,
                     -(zfar * znear) / (zfar - znear) * one]),
        torch.stack([zero, zero, one, zero]),
    ])
    full = P @ view
    return CameraParams(
        viewmatrix=view,
        projmatrix=full,
        campos=pose[:3, 3],
        intrinsics=torch.stack([fx, fy, cx, cy]).to(torch.float32),
        tan_fov=torch.stack([w / (2.0 * fx), h / (2.0 * fy)]).to(torch.float32),
    )


def camera_project(cameras: Cameras, xyz: np.ndarray) -> np.ndarray:
    """Project world points to image coordinates (host numpy; a single,
    unbatched camera). Points at or behind the camera plane project as if
    at uv = 0, as in the JAX package."""
    eps = np.finfo(xyz.dtype).eps
    if xyz.shape[-1] != 3:
        raise ValueError(f"points must be [..., 3], got {xyz.shape}")
    origins = cameras.poses[..., :3, 3]
    rotation = cameras.poses[..., :3, :3]
    uvw = xyz - origins
    # (rotation * uvw[..., :, None]).sum(-2) is R^T @ v
    uvw = (rotation * uvw[..., :, None]).sum(-2)
    uv = np.where(uvw[..., 2:] > eps, uvw[..., :2] / uvw[..., 2:], np.zeros_like(uvw[..., :2]))
    x, y = np.moveaxis(uv, -1, 0)
    fx, fy, cx, cy = np.moveaxis(np.asarray(cameras.intrinsics), -1, 0)
    x = fx * x + cx
    y = fy * y + cy
    return np.stack((x, y), -1)


def get_cameras_extent(cameras: Cameras) -> float:
    """Scene radius from the camera centers (1.1 x the largest distance to
    their mean); sets the trainer's spatial learning-rate scale."""
    c2w = cameras.poses
    cam_centers = np.hstack(list(c2w[:, :3, 3:4]))
    avg_cam_center = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - avg_cam_center, axis=0, keepdims=True)
    diagonal = np.max(dist)
    return float(diagonal * 1.1)
