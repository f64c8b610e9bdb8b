"""Skybox Gaussian generation on a Fibonacci sphere (init-time, host numpy).

Counterpart of `wildgaussians_tpu/models/sky.py`: uniform sphere points at
10x the 97th-percentile scene radius, kept only where some training camera
sees them in the top 2/3 of its image.
"""
import math
from typing import Tuple

import numpy as np

from ..cameras import camera_project
from ..types import Cameras


def uniform_sphere_fibonacci(num_points: int) -> np.ndarray:
    phi = math.pi * (3.0 - math.sqrt(5.0))
    n = (num_points - 1) / 2
    i = np.linspace(-n, n, num_points, dtype=np.float32)
    lat = np.arcsin(2.0 * i / (2 * n + 1))
    lon = phi * i
    x = np.cos(lon) * np.cos(lat)
    y = np.sin(lon) * np.cos(lat)
    z = np.sin(lat)
    return np.stack([x, y, z], -1).astype(np.float32)


def get_sky_points(num_points: int, points3d: np.ndarray,
                   cameras: Cameras) -> Tuple[np.ndarray, float]:
    """Returns (sky_xyz [K,3], sky_distance / 2)."""
    points = uniform_sphere_fibonacci(num_points)
    mean = points3d.mean(0, keepdims=True)
    sky_distance = float(np.quantile(np.linalg.norm(points3d - mean, axis=-1), 0.97) * 10)
    points = points * sky_distance + mean
    gmask = np.zeros((points.shape[0],), bool)
    for cam in cameras:
        rest = ~gmask
        uv = camera_project(cam, points[rest])
        mask = ~np.isnan(uv).any(-1)
        if cam.image_sizes is None:
            raise ValueError("a training camera has no image size")
        mask = mask & (uv[..., -1] < 2 / 3 * cam.image_sizes[..., 1])
        gmask[rest] = gmask[rest] | mask
    return points[gmask].astype(np.float32), sky_distance / 2
