"""COLMAP dataset loader: the port's copy of
`wildgaussians_tpu/datasets/colmap.py` (an every-8th test split, or
`{train,test}_list.txt` where the scene has them)."""
import logging
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ..spans import span
from ..types import camera_model_to_int, new_cameras
from ..utils import Indices
from .colmap_utils import (Camera, qvec2rotmat, read_cameras_binary,
                           read_cameras_text, read_images_binary,
                           read_images_text, read_points3D_binary,
                           read_points3D_text)
from .common import (DatasetNotFoundError, dataset_index_select,
                     get_default_viewer_transform, new_dataset)

logger = logging.getLogger(__name__)

# COLMAP model -> (ours, param picker). Parameter layouts follow
# https://github.com/colmap/colmap/blob/dev/src/base/camera_models.h
# (mirrors the dispatch at reference colmap.py:26-210).
_DISTORTION_KEYS = ("k1", "k2", "p1", "p2", "k3", "k4")


def _parse_colmap_camera_params(camera: Camera) -> Tuple[np.ndarray, int, np.ndarray, Tuple[int, int]]:
    p = camera.params
    d = {}
    if camera.model == "SIMPLE_PINHOLE":
        fx = fy = p[0]; cx, cy = p[1], p[2]; model = "pinhole"  # noqa: E702
    elif camera.model == "PINHOLE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]; model = "pinhole"  # noqa: E702
    elif camera.model == "SIMPLE_RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]; d["k1"] = p[3]; model = "opencv"  # noqa: E702
    elif camera.model == "RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]; d["k1"], d["k2"] = p[3], p[4]; model = "opencv"  # noqa: E702
    elif camera.model == "OPENCV":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        d["k1"], d["k2"], d["p1"], d["p2"] = p[4], p[5], p[6], p[7]
        model = "opencv"
    elif camera.model == "OPENCV_FISHEYE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        d["k1"], d["k2"], d["k3"], d["k4"] = p[4], p[5], p[6], p[7]
        model = "opencv_fisheye"
    elif camera.model == "SIMPLE_RADIAL_FISHEYE":
        fx = fy = p[0]; cx, cy = p[1], p[2]; d["k1"] = p[3]; model = "opencv_fisheye"  # noqa: E702
    elif camera.model == "RADIAL_FISHEYE":
        fx = fy = p[0]; cx, cy = p[1], p[2]
        d["k1"], d["k2"] = p[3], p[4]
        model = "opencv_fisheye"
    elif camera.model == "FULL_OPENCV":
        # fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6 — parsed for the
        # diagnostic path but, exactly like the reference (colmap.py:102-126),
        # the rational radial model (k4..k6 denominator) is not supported
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        d["k1"], d["k2"], d["p1"], d["p2"] = p[4], p[5], p[6], p[7]
        d["k3"], d["k4"], d["k5"], d["k6"] = p[8], p[9], p[10], p[11]
        raise NotImplementedError(f"{camera.model} camera model is not supported yet!")
    elif camera.model == "FOV":
        # fx, fy, cx, cy, omega — parsed but unsupported (reference
        # colmap.py:128-135 raises identically)
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        d["omega"] = p[4]
        raise NotImplementedError(f"{camera.model} camera model is not supported yet!")
    else:
        # incl. THIN_PRISM_FISHEYE (reference colmap.py:178-180)
        raise NotImplementedError(f"{camera.model} camera model is not supported yet!")
    intrinsics = np.array([fx, fy, cx, cy], dtype=np.float32)
    distortion = np.array([d.get(k, 0.0) for k in _DISTORTION_KEYS], dtype=np.float32)
    return intrinsics, camera_model_to_int(model), distortion, (camera.width, camera.height)


def load_colmap_dataset(path: Union[Path, str],
                        images_path: Optional[Union[str, Path]] = None,
                        split: Optional[str] = None,
                        test_indices: Optional[Indices] = None,
                        features=None,
                        colmap_path: Optional[Union[str, Path]] = None):
    path = Path(path)
    features = features or frozenset()
    load_points = "points3D_xyz" in features or "points3D_rgb" in features
    if split:
        assert split in {"train", "test"}
    if colmap_path is None:
        colmap_path = Path("sparse") / "0"
        if not (path / colmap_path).exists():
            colmap_path = Path("sparse")
    colmap_path = path / Path(colmap_path)
    if images_path is None:
        images_path = Path("images")
    images_path = path / Path(images_path)
    if not colmap_path.exists():
        raise DatasetNotFoundError("Missing 'sparse/0' folder in COLMAP dataset")
    if not images_path.exists():
        raise DatasetNotFoundError("Missing 'images' folder in COLMAP dataset")

    def _read(stem, bin_reader, txt_reader):
        if (colmap_path / f"{stem}.bin").exists():
            return bin_reader(colmap_path / f"{stem}.bin")
        if (colmap_path / f"{stem}.txt").exists():
            return txt_reader(colmap_path / f"{stem}.txt")
        raise DatasetNotFoundError(
            f"Missing '{colmap_path}/{stem}.(bin|txt)' file in COLMAP dataset")

    colmap_cameras = _read("cameras", read_cameras_binary, read_cameras_text)
    images = _read("images", read_images_binary, read_images_text)
    points3D = None
    if load_points:
        with span("points3D_parse"):
            points3D = _read("points3D", read_points3D_binary, read_points3D_text)

    camera_intrinsics, camera_poses, camera_models = [], [], []
    camera_distortion, camera_sizes = [], []
    image_paths: List[str] = []
    image_names = []
    for image in images.values():
        camera = colmap_cameras[image.camera_id]
        intrinsics, camera_model, distortion, (w, h) = _parse_colmap_camera_params(camera)
        camera_sizes.append(np.array((w, h), np.int32))
        camera_intrinsics.append(intrinsics)
        camera_models.append(camera_model)
        camera_distortion.append(distortion)
        image_names.append(image.name)
        image_paths.append(str(images_path / image.name))
        rotation = qvec2rotmat(image.qvec).astype(np.float64)
        w2c = np.concatenate([rotation, image.tvec.reshape(3, 1).astype(np.float64)], 1)
        w2c = np.concatenate([w2c, np.array([[0, 0, 0, 1]], w2c.dtype)], 0)
        camera_poses.append(np.linalg.inv(w2c)[:3, :])

    near = 0.01
    centers = np.stack([x[:3, -1] for x in camera_poses], 0)
    far = float(np.percentile(
        np.linalg.norm(centers - np.mean(centers, keepdims=True, axis=0), axis=-1), 90))
    nears_fars = np.array([[near, far]] * len(camera_poses), np.float32)

    points3D_xyz = points3D_rgb = None
    if load_points:
        assert points3D is not None
        points3D_xyz = np.array([p.xyz for p in points3D.values()], np.float32)
        points3D_rgb = np.array([p.rgb for p in points3D.values()], np.uint8)

    all_cameras = new_cameras(
        poses=np.stack(camera_poses, 0).astype(np.float32),
        intrinsics=np.stack(camera_intrinsics, 0).astype(np.float32),
        camera_models=np.array(camera_models, np.int32),
        distortion_parameters=np.stack(camera_distortion, 0).astype(np.float32),
        image_sizes=np.stack(camera_sizes, 0).astype(np.int32),
        nears_fars=nears_fars,
    )

    indices = None
    train_indices = np.arange(len(image_paths))
    if split is not None:
        if test_indices is None and ((path / "train_list.txt").exists()
                                     or (path / "test_list.txt").exists()):
            logger.info("Loading split from %s", path / f"{split}_list.txt")
            train_indices = None
            for split_name in ("train", split):
                split_names = set((path / f"{split_name}_list.txt").read_text().splitlines())
                indices = np.array([name in split_names for name in image_names], bool)
                if indices.sum() == 0:
                    raise DatasetNotFoundError(
                        f"no images found for split {split_name} in {path / f'{split_name}_list.txt'}")
                if split_name == "train":
                    train_indices = indices
            assert train_indices is not None
        else:
            if test_indices is None:
                test_indices = Indices.every_iters(8)
            test_indices.total = len(image_paths)
            test_mask = np.array([i in test_indices for i in range(len(image_paths))], bool)
            train_indices = ~test_mask
            indices = train_indices if split == "train" else test_mask

    viewer_transform, viewer_pose = get_default_viewer_transform(
        all_cameras[train_indices].poses, None)
    dataset = new_dataset(
        cameras=all_cameras,
        image_paths=image_paths,
        points3D_xyz=points3D_xyz,
        points3D_rgb=points3D_rgb,
        mask_paths=None,
        image_paths_root=str(images_path),
        metadata={
            "name": None,
            "color_space": "srgb",
            "viewer_transform": viewer_transform,
            "viewer_initial_pose": viewer_pose,
        })
    if indices is not None:
        dataset = dataset_index_select(dataset, indices)
    return dataset
