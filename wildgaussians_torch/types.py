"""Public contracts of the port: cameras, datasets, render output and the
method, evaluation-protocol and logger protocols.

The port's own copy of `wildgaussians_tpu/types.py`, with the `Trajectory*`
types of trajectory rendering (`evaluation.render_frames`). Containers are
numpy-based on the host; the render path moves what it needs to the device
itself.
"""
import dataclasses
import typing
from abc import abstractmethod
from dataclasses import dataclass
from typing import (Any, Callable, Dict, FrozenSet, Iterable, Iterator, List, Literal, Optional,
                    Protocol, Sequence, Tuple, Union, get_args, runtime_checkable)

import numpy as np

try:
    from typing import NotRequired, Required, TypedDict
except ImportError:  # pragma: no cover
    from typing_extensions import NotRequired, Required, TypedDict  # type: ignore

CameraModel = Literal["pinhole", "opencv", "opencv_fisheye", "full_opencv"]
DatasetFeature = Literal["color", "points3D_xyz", "points3D_rgb"]


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


class UnloadedDataset(_IncompleteDataset):
    """A dataset whose images are not decoded yet (dataset_load_features)."""
    images: NotRequired[Optional[Union[np.ndarray, List[np.ndarray]]]]


class Dataset(_IncompleteDataset):
    """A loaded training set: cameras, images (uint8 or float [H, W, 3+]),
    optional occluder masks and the sparse point cloud that seeds the
    Gaussians."""
    images: Union[np.ndarray, List[np.ndarray]]


class RenderOutput(TypedDict, total=False):
    color: Required[np.ndarray]  # [h w 3]
    depth: np.ndarray  # [h w]
    accumulation: np.ndarray  # [h w]


class TrajectoryFrameAppearance(TypedDict, total=False):
    embedding: Optional[np.ndarray]
    embedding_train_index: Optional[int]


class TrajectoryFrame(TypedDict, total=True):
    pose: np.ndarray
    intrinsics: np.ndarray
    appearance_weights: NotRequired[np.ndarray]


class TrajectoryKeyframe(TypedDict, total=True):
    pose: np.ndarray
    fov: Optional[float]
    transition_duration: NotRequired[Optional[float]]
    appearance: NotRequired[TrajectoryFrameAppearance]


TrajectoryInterpolationType = Literal["kochanek-bartels", "none"]


class ImageSetInterpolationSource(TypedDict, total=True):
    type: Literal["interpolation"]
    interpolation: Literal["none"]
    keyframes: List[TrajectoryKeyframe]
    default_fov: float
    default_transition_duration: float
    default_appearance: NotRequired[Optional[TrajectoryFrameAppearance]]


class KochanekBartelsInterpolationSource(TypedDict, total=True):
    type: Literal["interpolation"]
    interpolation: Literal["kochanek-bartels"]
    is_cycle: bool
    tension: float
    keyframes: List[TrajectoryKeyframe]
    default_fov: float
    default_transition_duration: float
    default_appearance: NotRequired[Optional[TrajectoryFrameAppearance]]


TrajectoryInterpolationSource = Union[ImageSetInterpolationSource,
                                      KochanekBartelsInterpolationSource]


class Trajectory(TypedDict, total=True):
    camera_model: CameraModel
    image_size: Tuple[int, int]
    frames: List[TrajectoryFrame]
    appearances: NotRequired[List[TrajectoryFrameAppearance]]
    fps: float
    source: NotRequired[Optional[TrajectoryInterpolationSource]]


class OptimizeEmbeddingOutput(TypedDict):
    embedding: np.ndarray
    render_output: RenderOutput
    metrics: NotRequired[Dict[str, Sequence[float]]]


class MethodInfo(TypedDict, total=False):
    method_id: Required[str]
    required_features: FrozenSet[DatasetFeature]
    supported_camera_models: FrozenSet


class ModelInfo(TypedDict, total=False):
    method_id: Required[str]
    num_iterations: Required[int]
    loaded_step: Optional[int]
    loaded_checkpoint: Optional[str]
    batch_size: int
    eval_batch_size: int
    required_features: FrozenSet[DatasetFeature]
    supported_camera_models: FrozenSet
    hparams: Dict[str, Any]


@runtime_checkable
class Method(Protocol):
    """The NerfBaselines-style method protocol."""

    def __init__(self, *,
                 checkpoint: Union[str, None] = None,
                 train_dataset: Optional[Dataset] = None,
                 config_overrides: Optional[Dict[str, Any]] = None):
        pass

    @classmethod
    def install(cls):
        pass

    @classmethod
    @abstractmethod
    def get_method_info(cls) -> MethodInfo:
        raise NotImplementedError()

    @abstractmethod
    def get_info(self) -> ModelInfo:
        raise NotImplementedError()

    @abstractmethod
    def get_train_embedding(self, index: int) -> Optional[np.ndarray]:
        return None

    @abstractmethod
    def optimize_embedding(self, dataset: Dataset, *,
                           embedding: Optional[np.ndarray] = None) -> OptimizeEmbeddingOutput:
        raise NotImplementedError()

    @abstractmethod
    def render(self, camera: Cameras, *, options: Optional[Dict] = None) -> RenderOutput:
        raise NotImplementedError()

    @abstractmethod
    def train_iteration(self, step: int):
        raise NotImplementedError()

    @abstractmethod
    def save(self, path: str):
        raise NotImplementedError()


@runtime_checkable
class EvaluationProtocol(Protocol):
    def get_name(self) -> str: ...
    def render(self, method: Method, dataset: Dataset) -> RenderOutput: ...
    def evaluate(self, predictions: RenderOutput,
                 dataset: Dataset) -> Dict[str, Union[float, int]]: ...
    def accumulate_metrics(self, metrics: Iterable[Dict[str, Union[float, int]]]
                           ) -> Dict[str, Union[float, int]]: ...


@runtime_checkable
class LoggerEvent(Protocol):
    def add_scalar(self, tag: str, value: Union[float, int]) -> None: ...
    def add_text(self, tag: str, text: str) -> None: ...
    def add_image(self, tag: str, image: np.ndarray, display_name: Optional[str] = None,
                  description: Optional[str] = None, **kwargs) -> None: ...
    def add_embedding(self, tag: str, embeddings: np.ndarray, *,
                      images: Optional[List[np.ndarray]] = None,
                      labels: Union[None, List[Dict[str, str]], List[str]] = None) -> None: ...
    def add_plot(self, tag: str, *data: np.ndarray,
                 axes_labels: Optional[Sequence[str]] = None,
                 title: Optional[str] = None, **kwargs) -> None: ...
    def add_histogram(self, tag: str, values: np.ndarray, *,
                      num_bins: Optional[int] = None) -> None: ...


@runtime_checkable
class Logger(Protocol):
    def add_event(self, step: int) -> typing.ContextManager[LoggerEvent]: ...
    def add_scalar(self, tag: str, value: Union[float, int], step: int) -> None: ...
    def add_text(self, tag: str, text: str, step: int) -> None: ...
    def add_image(self, tag: str, image: np.ndarray, step: int, *,
                  display_name: Optional[str] = None,
                  description: Optional[str] = None) -> None: ...
    def add_embedding(self, tag: str, embeddings: np.ndarray, step: int, *,
                      images: Optional[List[np.ndarray]] = None,
                      labels: Union[None, List[Dict[str, str]], List[str]] = None) -> None: ...
