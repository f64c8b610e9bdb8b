"""Public contracts of the port: cameras, the training dataset and the
render output.

The port's own copy of the parts of `wildgaussians_tpu/types.py` that
rendering and training use (Cameras, new_cameras, camera_model_to_int,
Dataset, RenderOutput).
Containers are numpy-based on the host; the render path moves what it needs
to the device itself.
"""
import dataclasses
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Literal, Optional, Sequence, Union,
                    get_args)

import numpy as np

try:
    from typing import Required, TypedDict
except ImportError:  # pragma: no cover
    from typing_extensions import Required, TypedDict  # type: ignore

CameraModel = Literal["pinhole", "opencv", "opencv_fisheye", "full_opencv"]


def camera_model_to_int(camera_model: CameraModel) -> int:
    camera_models = get_args(CameraModel)
    if camera_model not in camera_models:
        raise ValueError(f"Unknown camera model {camera_model}, known models are {camera_models}")
    return camera_models.index(camera_model)


@dataclass(frozen=True)
class Cameras:
    """Batch (or single, if unbatched shapes) of cameras.

      poses: [N, 3, 4] camera-to-world (OpenCV convention: x right, y down, z forward)
      intrinsics: [N, 4] (fx, fy, cx, cy)
      camera_models: [N] int (see camera_model_to_int)
      distortion_parameters: [N, P]
      image_sizes: [N, 2] (width, height)
      nears_fars: [N, 2] or None
      metadata: [N, ...] or None
    """
    poses: np.ndarray
    intrinsics: np.ndarray
    camera_models: np.ndarray
    distortion_parameters: np.ndarray
    image_sizes: np.ndarray
    nears_fars: Optional[np.ndarray] = None
    metadata: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return 1 if len(self.poses.shape) == 2 else len(self.poses)

    def item(self) -> "Cameras":
        if len(self) != 1:
            raise ValueError("Cameras must have exactly one element to be converted to a single camera")
        return self if len(self.poses.shape) == 2 else self[0]

    def __getitem__(self, index) -> "Cameras":
        return type(self)(
            poses=self.poses[index],
            intrinsics=self.intrinsics[index],
            camera_models=self.camera_models[index],
            distortion_parameters=self.distortion_parameters[index],
            image_sizes=self.image_sizes[index],
            nears_fars=self.nears_fars[index] if self.nears_fars is not None else None,
            metadata=self.metadata[index] if self.metadata is not None else None,
        )

    def __iter__(self) -> Iterator["Cameras"]:
        for i in range(len(self)):
            yield self[i]

    @classmethod
    def cat(cls, values: Sequence["Cameras"]) -> "Cameras":
        nears_fars = metadata = None
        if any(v.nears_fars is not None for v in values):
            nears_fars = np.concatenate([v.nears_fars for v in values])  # type: ignore
        if any(v.metadata is not None for v in values):
            metadata = np.concatenate([v.metadata for v in values])  # type: ignore
        return cls(
            poses=np.concatenate([v.poses for v in values]),
            intrinsics=np.concatenate([v.intrinsics for v in values]),
            camera_models=np.concatenate([v.camera_models for v in values]),
            distortion_parameters=np.concatenate([v.distortion_parameters for v in values]),
            image_sizes=np.concatenate([v.image_sizes for v in values]),
            nears_fars=nears_fars,
            metadata=metadata,
        )

    def replace(self, **changes) -> "Cameras":
        return dataclasses.replace(self, **changes)

    def apply(self, fn: Callable[[np.ndarray, str], np.ndarray]) -> "Cameras":
        return Cameras(
            poses=fn(self.poses, "poses"),
            intrinsics=fn(self.intrinsics, "intrinsics"),
            camera_models=fn(self.camera_models, "camera_models"),
            distortion_parameters=fn(self.distortion_parameters, "distortion_parameters"),
            image_sizes=fn(self.image_sizes, "image_sizes"),
            nears_fars=fn(self.nears_fars, "nears_fars") if self.nears_fars is not None else None,
            metadata=fn(self.metadata, "metadata") if self.metadata is not None else None,
        )


def new_cameras(
    *,
    poses: np.ndarray,
    intrinsics: np.ndarray,
    camera_models: np.ndarray,
    distortion_parameters: np.ndarray,
    image_sizes: np.ndarray,
    nears_fars: Optional[np.ndarray] = None,
    metadata: Optional[np.ndarray] = None,
) -> Cameras:
    return Cameras(
        poses=poses,
        intrinsics=intrinsics,
        camera_models=camera_models,
        distortion_parameters=distortion_parameters,
        image_sizes=image_sizes,
        nears_fars=nears_fars,
        metadata=metadata,
    )


class _IncompleteDataset(TypedDict, total=True):
    cameras: Cameras
    image_paths: List[str]
    image_paths_root: str
    mask_paths: Optional[List[str]]
    mask_paths_root: Optional[str]
    metadata: Dict
    masks: Optional[Union[np.ndarray, List[np.ndarray]]]
    points3D_xyz: Optional[np.ndarray]
    points3D_rgb: Optional[np.ndarray]
    images_points3D_indices: Optional[List[np.ndarray]]


class Dataset(_IncompleteDataset):
    """A loaded training set: cameras, images (uint8 or float [H, W, 3+]),
    optional occluder masks and the sparse point cloud that seeds the
    Gaussians."""
    images: Union[np.ndarray, List[np.ndarray]]


class RenderOutput(TypedDict, total=False):
    color: Required[np.ndarray]  # [h w 3]
    depth: np.ndarray  # [h w]
    accumulation: np.ndarray  # [h w]
