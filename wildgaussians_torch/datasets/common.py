"""Dataset plumbing: feature loading, intrinsics rescale, index select,
viewer and pose transforms (host numpy).

The port's copy of `wildgaussians_tpu/datasets/common.py`. PIL is imported
where images are decoded, not with the module.
"""
import logging
import os
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..types import Cameras, Dataset, UnloadedDataset

logger = logging.getLogger(__name__)

METADATA_COLUMNS = ["exposure"]


class DatasetNotFoundError(Exception):
    pass


def single(xs):
    out = None
    for x in xs:
        if out is not None:
            raise ValueError("Expected single value, got multiple")
        out = x
    if out is None:
        raise ValueError("Expected single value, got none")
    return out


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def rotation_matrix(a, b):
    """Rotation taking unit vector a to b (reference _common.py:24-50)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = np.dot(a, b)
    if c < -1 + 1e-8:
        eps = (np.random.rand(3) - 0.5) * 0.01
        return rotation_matrix(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=a.dtype)
    return np.eye(3, dtype=a.dtype) + skew + skew @ skew * ((1 - c) / (s ** 2 + 1e-8))


def get_transform_poses_pca(poses):
    """PCA-based recentering transform (reference _common.py:92-116)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_recentered.mean(axis=0)[2, 1] > 0:
        transform = np.diag(np.array([1, -1, -1, 1])) @ transform
    scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform
    return transform


def get_transform_and_scale(transform):
    scale = np.linalg.norm(transform[:3, :3], axis=0)
    assert np.allclose(scale, scale[0], rtol=1e-3, atol=0)
    scale = float(np.mean(scale).item())
    transform = transform.copy()
    transform[:3, :] /= scale
    return transform, scale


def apply_transform(transform, poses):
    transform, scale = get_transform_and_scale(transform)
    poses = unpad_poses(transform @ pad_poses(poses))
    poses[..., :3, 3] *= scale
    return poses


def get_default_viewer_transform(poses, dataset_type: Optional[str]):
    """reference _common.py:128-163 (only the generic branch is used here)."""
    if dataset_type is None:
        origins = poses[..., :3, 3]
        mean_origin = np.mean(origins, 0)
        up = np.mean(poses[:, :3, 1], 0)
        up = -up / np.linalg.norm(up)
        rotation = rotation_matrix(up, np.array([0, 0, 1], dtype=up.dtype))
        transform = np.concatenate([rotation, rotation @ -mean_origin[..., None]], -1)
        transform = np.concatenate([transform, np.array([[0, 0, 0, 1]], dtype=transform.dtype)], 0)
        maxlen = np.quantile(np.abs(poses[..., 0:3, 3] - mean_origin[None]).max(-1), 0.95) * 1.1
        scale = float(1 / maxlen)
        transform = np.diag([scale, scale, scale, 1]) @ transform
        camera = apply_transform(transform, poses[0])
        return transform, camera[..., :3, :4]
    elif dataset_type == "object-centric":
        transform = get_transform_poses_pca(poses)
        poses_t = apply_transform(transform, poses)
        return transform, poses_t[0][..., :3, :4]
    raise ValueError(f"Dataset type {dataset_type} is not supported")


def get_scene_scale(cameras: Cameras, dataset_type: Optional[str]):
    """reference _common.py:170-182."""
    if dataset_type in (None, "object-centric"):
        centers = cameras.poses[..., :3, 3]
        return float(np.percentile(np.linalg.norm(centers - centers.mean(), axis=-1), 90))
    if dataset_type == "forward-facing":
        assert cameras.nears_fars is not None
        return float(cameras.nears_fars.mean())
    raise ValueError(f"Dataset type {dataset_type} is not supported")


def get_image_metadata(image):
    """EXIF exposure metadata of a PIL image (reference _common.py:185-199)."""
    import PIL.ExifTags
    values = {}
    try:
        exif_pil = image.getexif()
    except AttributeError:  # pragma: no cover
        exif_pil = getattr(image, "_getexif", lambda: None)()
    if exif_pil is not None:
        exif = {PIL.ExifTags.TAGS[k]: v for k, v in exif_pil.items() if k in PIL.ExifTags.TAGS}
        if "ExposureTime" in exif and "ISOSpeedRatings" in exif:
            values["exposure"] = exif["ExposureTime"] * exif["ISOSpeedRatings"] / 1000.0
    return np.array([values.get(c, np.nan) for c in METADATA_COLUMNS], dtype=np.float32)


def _rescale_intrinsics(dataset, image_sizes: np.ndarray):
    """Adjust intrinsics after downscaled images (reference _common.py:202-232)."""
    cameras = dataset["cameras"]
    if np.any(cameras.image_sizes != image_sizes):
        logger.info("Image sizes do not match camera sizes, rescaling intrinsics")
        multx, multy = np.moveaxis(
            image_sizes.astype(np.float64) / cameras.image_sizes.astype(np.float64), -1, 0)
        multipliers = np.stack([multx, multy, multx, multy], -1)
        dataset["cameras"] = cameras.replace(
            image_sizes=image_sizes,
            intrinsics=(cameras.intrinsics * multipliers).astype(cameras.intrinsics.dtype))


def dataset_load_features(dataset: UnloadedDataset, features=None,
                          supported_camera_models=None) -> Dataset:
    """Decode images/masks from disk (reference _common.py:235-323)."""
    import PIL.Image
    del features
    images: List[np.ndarray] = []
    image_sizes = []
    all_metadata = []
    resize = dataset["metadata"].get("downscale_loaded_factor")
    if resize == 1:
        resize = None

    for p in dataset["image_paths"]:
        if str(p).endswith(".bin"):
            assert dataset["metadata"]["color_space"] == "linear"
            with open(p, "rb") as f:
                data_bytes = f.read()
            h, w = struct.unpack("ii", data_bytes[:8])
            image = np.frombuffer(data_bytes, dtype=np.float16, count=h * w * 4,
                                  offset=8).astype(np.float32).reshape([h, w, 4])
            metadata = np.full((len(METADATA_COLUMNS),), np.nan, np.float32)
        else:
            assert dataset["metadata"]["color_space"] == "srgb"
            pil_image = PIL.Image.open(p)
            metadata = get_image_metadata(pil_image)
            if resize is not None:
                w, h = pil_image.size
                pil_image = pil_image.resize((round(w / resize), round(h / resize)),
                                             PIL.Image.Resampling.BICUBIC)
            image = np.array(pil_image.convert("RGB"), dtype=np.uint8)
        images.append(image)
        image_sizes.append([image.shape[1], image.shape[0]])
        all_metadata.append(metadata)

    if dataset["mask_paths"] is not None:
        masks = []
        for p in dataset["mask_paths"]:
            mask = PIL.Image.open(p).convert("L")
            if resize is not None:
                w, h = mask.size
                mask = mask.resize((round(w / resize), round(h / resize)),
                                   PIL.Image.Resampling.NEAREST)
            masks.append(np.array(mask, dtype=np.uint8).astype(bool))
        dataset["masks"] = masks

    dataset["images"] = images
    _rescale_intrinsics(dataset, np.array(image_sizes, np.int32))
    if supported_camera_models is not None and set(supported_camera_models) != {"pinhole"}:
        raise RuntimeError("Some camera models are not supported by the method.")
    return dataset  # type: ignore


def dataset_index_select(dataset, i):
    """reference _common.py:358-388."""
    assert isinstance(i, (slice, int, list, np.ndarray))
    dataset_len = len(dataset["image_paths"])

    def index(key, obj):
        if obj is None:
            return None
        if key == "cameras":
            return obj[i] if len(obj) != 1 else obj
        if isinstance(obj, np.ndarray):
            if obj.shape[0] == 1:
                return obj[0] if isinstance(i, int) else obj
            return obj[i]
        if isinstance(obj, list):
            indices = np.arange(dataset_len)[i]
            if indices.ndim == 0:
                return obj[indices]
            return [obj[j] for j in indices]
        raise ValueError(f"Cannot index object of type {type(obj)} at key {key}")

    out = dict(dataset)
    out.update({k: index(k, v) for k, v in dataset.items()
                if k not in {"image_paths_root", "mask_paths_root", "points3D_xyz",
                             "points3D_rgb", "metadata"}})
    return out


def new_dataset(*, cameras: Cameras, image_paths: Sequence[str],
                image_paths_root: Optional[str] = None,
                images=None, mask_paths: Optional[Sequence[str]] = None,
                mask_paths_root: Optional[str] = None, masks=None,
                points3D_xyz: Optional[np.ndarray] = None,
                points3D_rgb: Optional[np.ndarray] = None,
                images_points3D_indices=None,
                metadata: Optional[Dict] = None) -> Union[Dataset, UnloadedDataset]:
    if image_paths_root is None:
        image_paths_root = os.path.commonpath(image_paths)
    if mask_paths_root is None and mask_paths is not None:
        mask_paths_root = os.path.commonpath(mask_paths)
    return UnloadedDataset(
        cameras=cameras,
        image_paths=list(image_paths),
        mask_paths=list(mask_paths) if mask_paths is not None else None,
        mask_paths_root=mask_paths_root,
        image_paths_root=image_paths_root,
        images=images,
        masks=masks,
        points3D_xyz=points3D_xyz,
        points3D_rgb=points3D_rgb,
        images_points3D_indices=(list(images_points3D_indices)
                                 if images_points3D_indices is not None else None),
        metadata=metadata or {},
    )
