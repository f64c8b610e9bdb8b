"""Metrics, evaluation protocols, prediction rendering and archiving.

The port's copy of `wildgaussians_tpu/evaluation.py`, with trajectory
rendering (`render_frames`, `trajectory_get_cameras`,
`trajectory_get_embeddings`: frames to a directory or a .tar.gz, video
only where `mediapy` is installed, depth frames only where `matplotlib`
is). Metrics stay numpy on the host: SSIM matches dm_pix (valid-mode separable Gaussian, variance floors,
covariance clipping), PSNR, MSE and MAE clip to [0, 1] first, LPIPS runs
the torch trunks on the CPU when their weights are on disk and is NaN (with
one warning) when they are not, and the results JSON keeps the
base64-packed raw metric lists.
"""
import base64
import contextlib
import io
import json
import logging
import os
import tarfile
import time
import typing
import warnings
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from .datasets import dataset_index_select, new_dataset
from .spans import span
from .types import (Cameras, Dataset, EvaluationProtocol, Literal, Method, RenderOutput,
                    Trajectory, camera_model_to_int, new_cameras)
from .utils import (convert_image_dtype, image_to_srgb, open_any_directory, read_image,
                    save_depth, save_image, serialize_nb_info, visualize_depth)

logger = logging.getLogger(__name__)
OutputType = Literal["color", "depth"]


def _utc_now() -> str:
    """The UTC time as the results' datetimes give it (no zone suffix)."""
    return datetime.now(timezone.utc).replace(tzinfo=None).isoformat(timespec="seconds")


# ---------------------------------------------------------------------------
# output sinks
# ---------------------------------------------------------------------------

class PredictionWriter:
    """Uniform file sink for prediction dumps: a directory tree or a .tar.gz
    archive, chosen by the output path suffix. Usage:

        with PredictionWriter.open(output) as w, w.file("color/x.png") as f:
            f.write(...)
    """

    @classmethod
    @contextlib.contextmanager
    def open(cls, output: Union[str, Path]):
        if str(output).endswith(".tar.gz"):
            with tarfile.open(output, "w:gz") as tar:
                yield _TarWriter(tar)
        else:
            yield _DirWriter(Path(output))


class _DirWriter(PredictionWriter):
    def __init__(self, root: Path):
        self._root = root

    @contextlib.contextmanager
    def file(self, relpath: str):
        path = self._root / relpath
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            yield f


class _TarWriter(PredictionWriter):
    def __init__(self, tar: tarfile.TarFile):
        self._tar = tar

    @contextlib.contextmanager
    def file(self, relpath: str):
        info = tarfile.TarInfo(name=relpath)
        info.mtime = int(time.time())
        with io.BytesIO() as buf:
            yield buf
            info.size = buf.tell()
            buf.seek(0)
            self._tar.addfile(tarinfo=info, fileobj=buf)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _flatten_batch(fn):
    """Lift an [N,H,W,C] metric to arbitrary leading batch dims."""
    import functools

    @functools.wraps(fn)
    def wrapped(a, b, **kwargs):
        batch = a.shape[:-3]
        out = fn(a.reshape(-1, *a.shape[-3:]), b.reshape(-1, *b.shape[-3:]),
                 **kwargs)
        return np.reshape(out, batch)
    return wrapped


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    half = size // 2
    offs = np.arange(size) - half + (2 * half - size + 1) / 2
    k = np.exp(-0.5 * (offs / sigma) ** 2)
    return k / k.sum()


def _valid_filter2d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable VALID-mode filtering over the H and W axes of [N,H,W,C]
    via sliding windows (one tensordot per axis, no python-level loops)."""
    win = np.lib.stride_tricks.sliding_window_view(x, len(kernel), axis=1)
    x = np.tensordot(win, kernel, axes=([-1], [0]))
    win = np.lib.stride_tricks.sliding_window_view(x, len(kernel), axis=2)
    return np.tensordot(win, kernel, axes=([-1], [0]))


@_flatten_batch
def dmpix_ssim(a: np.ndarray, b: np.ndarray, *, max_val: float = 1.0,
               kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
               k2: float = 0.03, return_map: bool = False,
               filter_fn: Optional[Callable] = None) -> np.ndarray:
    """SSIM matching dm_pix.ssim bit-for-bit in f32: valid-mode separable
    Gaussian moments with variance floors and covariance magnitude clipping
    (the reference vendors the same algorithm, evaluation.py:68-178)."""
    assert a.shape == b.shape, f"shape mismatch: {a.shape} vs {b.shape}"
    assert a.dtype.kind == "f" and b.dtype.kind == "f"
    if filter_fn is None:
        kernel = _gaussian_kernel(kernel_size, sigma)
        filter_fn = lambda z: _valid_filter2d(z, kernel)  # noqa: E731

    mu_a = filter_fn(a)
    mu_b = filter_fn(b)
    var_a = filter_fn(a * a) - mu_a * mu_a
    var_b = filter_fn(b * b) - mu_b * mu_b
    cov = filter_fn(a * b) - mu_a * mu_b

    eps = np.finfo(np.float32).eps ** 2
    var_a = np.maximum(eps, var_a)
    var_b = np.maximum(eps, var_b)
    cov = np.sign(cov) * np.minimum(np.sqrt(var_a * var_b), np.abs(cov))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
                / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))
    return ssim_map if return_map else ssim_map.mean(axis=(-3, -2, -1))


def _clip01(a: np.ndarray) -> np.ndarray:
    return np.clip(a, 0, 1).astype(np.float32)


def ssim(a: np.ndarray, b: np.ndarray):
    """Mean SSIM per image, inputs clipped to [0,1]."""
    assert a.shape == b.shape and a.dtype.kind == "f" and b.dtype.kind == "f"
    return dmpix_ssim(_clip01(a), _clip01(b))


def mse(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape and a.dtype.kind == "f" and b.dtype.kind == "f"
    return np.square(_clip01(a) - _clip01(b)).mean(axis=(-3, -2, -1))


def mae(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape and a.dtype.kind == "f" and b.dtype.kind == "f"
    return np.abs(_clip01(a) - _clip01(b)).mean(axis=(-3, -2, -1))


def psnr(a, b: Optional[np.ndarray] = None):
    value = a if b is None else mse(a, b)
    return -10 * np.log10(value)


_LPIPS_CACHE: Dict[str, object] = {}
_LPIPS_UNAVAILABLE_WARNED = False


def _lpips(a, b, net, version="0.1"):
    """LPIPS on the CPU; NaN, with one warning, when the weights are not on
    disk. Only the weights' absence (or an unreadable weight file) gives NaN:
    any other error raises."""
    global _LPIPS_UNAVAILABLE_WARNED
    assert a.shape == b.shape and a.dtype.kind == "f" and b.dtype.kind == "f"
    import torch
    model = _LPIPS_CACHE.get(net)
    if model is None:
        from .metrics_lpips import LPIPS
        try:
            model = LPIPS(net=net, version=version)
        except (FileNotFoundError, RuntimeError) as e:
            if not _LPIPS_UNAVAILABLE_WARNED:
                warnings.warn(f"LPIPS unavailable ({e}); reporting NaN")
                _LPIPS_UNAVAILABLE_WARNED = True
            return np.full(a.shape[:-3], np.nan, np.float32)
        _LPIPS_CACHE[net] = model
    batch = a.shape[:-3]

    def to_torch(x):
        flat = _clip01(x).reshape(-1, *x.shape[-3:])
        return torch.from_numpy(flat).permute(0, 3, 1, 2) * 2 - 1

    with torch.no_grad():
        out = model(to_torch(a), to_torch(b))
    return out.cpu().numpy().reshape(batch)


def lpips_alex(a, b):
    return _lpips(a, b, net="alex")


def lpips_vgg(a, b):
    return _lpips(a, b, net="vgg")


lpips = lpips_alex


def compute_metrics(pred, gt, *, reduce: bool = True,
                    run_lpips_vgg: bool = False):
    """The standard per-image metric set (reference evaluation.py:331-352)."""
    pred = convert_image_dtype(pred[..., :gt.shape[-1]], np.float32)
    gt = convert_image_dtype(gt, np.float32)
    mse_value = mse(pred, gt)
    metrics = {
        "psnr": psnr(mse_value),
        "ssim": ssim(gt, pred),
        "mae": mae(gt, pred),
        "mse": mse_value,
        "lpips": lpips(gt, pred),
    }
    if run_lpips_vgg:
        metrics["lpips_vgg"] = lpips_vgg(gt, pred)
    if reduce:
        metrics = {k: v.mean().item() for k, v in metrics.items()}
    return metrics


# ---------------------------------------------------------------------------
# evaluation protocols
# ---------------------------------------------------------------------------

class DefaultEvaluationProtocol(EvaluationProtocol):
    """Render with the method's stored state and compare in sRGB uint8
    (reference evaluation.py:437-469)."""
    _name = "default"
    _lpips_vgg = False

    def get_name(self):
        return self._name

    def render(self, method: Method, dataset: Dataset) -> RenderOutput:
        return method.render(dataset["cameras"].item())

    def evaluate(self, predictions: RenderOutput, dataset: Dataset):
        assert len(dataset["images"]) == 1, "evaluate() takes a single image"
        meta = dataset["metadata"]
        to_srgb = lambda img: image_to_srgb(  # noqa: E731
            img, np.uint8, color_space=meta["color_space"],
            background_color=meta.get("background_color"))
        pred = convert_image_dtype(to_srgb(predictions["color"]), np.float32)
        gt = convert_image_dtype(to_srgb(dataset["images"][0]), np.float32)
        return compute_metrics(pred[None], gt[None], reduce=True,
                               run_lpips_vgg=self._lpips_vgg)

    def accumulate_metrics(self, metrics: Iterable[Dict[str, Union[float, int]]]):
        totals: Dict[str, float] = {}
        count = 0
        for data in metrics:
            count += 1
            for k, v in data.items():
                totals[k] = totals.get(k, 0.0) + v
        return {k: v / count for k, v in totals.items()} if count else {}


class NerfEvaluationProtocol(DefaultEvaluationProtocol):
    _name = "nerf"
    _lpips_vgg = True


def evaluate(predictions: str, output: str, *, description: str = "evaluating",
             evaluation_protocol: EvaluationProtocol):
    """Evaluate a predictions dir/tarball into an output JSON (reference
    evaluation.py:355-434)."""
    if os.path.exists(output):
        raise FileExistsError(f"{output} already exists")

    with open_any_directory(predictions, "r") as root_str:
        root = Path(root_str)
        nb_info = json.loads((root / "info.json").read_text("utf8"))
        logger.info("Using evaluation protocol %s",
                    evaluation_protocol.get_name())

        relpaths = sorted(str(p.relative_to(root / "color"))
                          for p in (root / "color").rglob("*") if p.is_file())
        dataset = new_dataset(
            cameras=typing.cast(Cameras, None),
            image_paths=relpaths,
            image_paths_root=str(root / "color"),
            metadata=typing.cast(Dict, nb_info.get(
                "render_dataset_metadata", nb_info.get("dataset_metadata", {}))),
            images=[read_image(root / "gt-color" / name) for name in relpaths])

        per_image: Dict[str, List[float]] = {}

        def evaluated():
            for i, name in enumerate(relpaths):
                pred: RenderOutput = {"color": read_image(root / "color" / name)}
                with span("eval_metrics"):
                    row = evaluation_protocol.evaluate(
                        pred, dataset_index_select(dataset, [i]))
                for k, v in row.items():
                    per_image.setdefault(k, []).append(v)
                yield row

        summary = evaluation_protocol.accumulate_metrics(evaluated())
        return save_evaluation_results(
            str(output), metrics=summary, metrics_lists=per_image,
            evaluation_protocol=evaluation_protocol.get_name(),
            nb_info=nb_info)


# ---------------------------------------------------------------------------
# prediction rendering / archiving
# ---------------------------------------------------------------------------

def _relative_image_name(dataset: Dataset, i: int) -> Path:
    name = Path(dataset["image_paths"][i])
    root = dataset.get("image_paths_root")
    return name.relative_to(Path(root)) if root is not None else name


def _write_frame(writer, relname: Path, pred: RenderOutput, gt: np.ndarray,
                 camera, meta: dict):
    """Write one prediction's files (gt/pred color, camera, optional depth,
    linear variants) through a PredictionWriter backend."""
    color_space = meta["color_space"]
    bg = meta.get("background_color")
    as_srgb = lambda img: image_to_srgb(  # noqa: E731
        img, np.uint8, color_space=color_space, allow_alpha=True,
        background_color=bg)

    with span("png_encode"):
        with writer.file(f"gt-color/{relname.with_suffix('.png').as_posix()}") as f:
            save_image(f, as_srgb(gt))
        with writer.file(f"color/{relname.with_suffix('.png').as_posix()}") as f:
            save_image(f, as_srgb(pred["color"]))
    with writer.file(f"cameras/{relname.with_suffix('.npz').as_posix()}") as f:
        arrays = {}
        camera.apply(lambda arr, name: arrays.setdefault(name, arr))
        np.savez(f, **arrays)
    if "depth" in pred:
        with writer.file(f"depth/{relname.with_suffix('.bin').as_posix()}") as f:
            save_depth(f, pred["depth"])
        depth_rgb = visualize_depth(
            pred["depth"],
            near_far=camera.nears_fars[0] if camera.nears_fars is not None else None,
            expected_scale=meta.get("expected_scene_scale"))
        with writer.file(f"depth-rgb/{relname.with_suffix('.png').as_posix()}") as f:
            save_image(f, convert_image_dtype(depth_rgb, np.uint8))
    if color_space == "linear":
        with writer.file(f"gt-color-linear/{relname.with_suffix('.bin').as_posix()}") as f:
            save_image(f, gt)
        with writer.file(f"color-linear/{relname.with_suffix('.bin').as_posix()}") as f:
            save_image(f, pred["color"])


def save_predictions(output: str, predictions: Iterable[RenderOutput],
                     dataset: Dataset, *, nb_info=None) -> Iterable[RenderOutput]:
    """Write gt-color/color/cameras(+depth) to a dir or .tar.gz and re-yield
    each prediction (reference evaluation.py:676-761)."""
    meta = dataset["metadata"]
    bg = meta.get("background_color", None)
    assert bg is None or bg.dtype == np.uint8
    sizes = dataset["cameras"].image_sizes
    assert sizes is not None

    with PredictionWriter.open(output) as writer:
        with writer.file("info.json") as f:
            f.write(json.dumps(serialize_nb_info({
                **(nb_info or {}),
                "render_datetime": _utc_now(),
                "render_dataset_metadata": meta,
            }), indent=2).encode("utf-8"))
        for i, pred in enumerate(predictions):
            w, h = sizes[i]
            gt = dataset["images"][i][:h, :w]
            assert gt.shape[:2] == pred["color"].shape[:2], (
                f"gt size {gt.shape[:2]} != pred size {pred['color'].shape[:2]}")
            _write_frame(writer, _relative_image_name(dataset, i), pred, gt,
                         dataset["cameras"][i], meta)
            yield pred


def render_all_images(method: Method, dataset: Dataset, output: str, *,
                      description: str = "rendering all images",
                      nb_info: Optional[dict] = None,
                      evaluation_protocol: EvaluationProtocol) -> Iterable[RenderOutput]:
    """Render every dataset camera through the protocol and archive
    (reference evaluation.py:477-514)."""
    logger.info("Rendering images with evaluation protocol %s",
                evaluation_protocol.get_name())
    info = dict(nb_info or {})
    info["evaluation_protocol"] = evaluation_protocol.get_name()
    def frames():
        for i in range(len(dataset["image_paths"])):
            with span("eval_render"):
                frame = evaluation_protocol.render(method, dataset_index_select(dataset, [i]))
            yield frame
    yield from save_predictions(output, frames(), dataset=dataset, nb_info=info)


def render_frames(method: Method, cameras: Cameras, output: Union[str, Path],
                  fps: float, embeddings: Optional[List[np.ndarray]] = None,
                  description: str = "rendering frames",
                  output_type: OutputType = "color",
                  nb_info: Optional[dict] = None) -> None:
    """Render a camera trajectory to PNG frames `00000.png`, ... in a
    directory or a .tar.gz, or to a video (.mp4 or .gif, which needs
    `mediapy`), each frame with its embedding from `embeddings` (or the
    method's default). `output_type` "depth" writes colormapped depth (which
    needs `matplotlib`) where the method's render gives depth; as in the
    JAX package, the render is asked for no extra outputs, so
    `WildGaussians` frames are color only."""
    del description
    output = str(output)
    assert cameras.image_sizes is not None
    info = nb_info or {}

    def frames(allow_alpha=True):
        for i, cam in enumerate(cameras):
            with span("frame_render"):
                pred = method.render(cam, options={
                    "embedding": embeddings[i] if embeddings is not None else None})
            if output_type == "color":
                yield image_to_srgb(pred["color"], np.uint8, color_space="srgb",
                                    allow_alpha=allow_alpha,
                                    background_color=info.get("background_color"))
            elif output_type == "depth":
                assert "depth" in pred, "Method does not output depth"
                nf = cameras.nears_fars[i] if cameras.nears_fars is not None else None
                yield convert_image_dtype(
                    visualize_depth(pred["depth"], near_far=nf,
                                    expected_scale=info.get("expected_scene_scale")),
                    np.uint8)
            else:
                raise RuntimeError(f"Output type {output_type} is not supported.")

    if output.endswith(".mp4") or output.endswith(".gif"):
        try:
            import mediapy
        except ImportError as e:
            raise RuntimeError("mediapy is required for video output") from e
        w, h = cameras.image_sizes[0]
        codec = "gif" if output.endswith(".gif") else "h264"
        with mediapy.VideoWriter(output, (h, w), fps=fps, codec=codec) as vw:
            for frame in frames(allow_alpha=False):
                vw.add_image(frame)
        return
    with PredictionWriter.open(output) as writer:
        for i, frame in enumerate(frames()):
            with span("png_encode"), writer.file(f"{i:05d}.png") as f:
                save_image(f, frame)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

def trajectory_get_cameras(trajectory: Trajectory) -> Cameras:
    """The camera batch of a viewer trajectory (pinhole only)."""
    if trajectory["camera_model"] != "pinhole":
        raise NotImplementedError("Only pinhole camera model is supported")
    frames = trajectory["frames"]
    n = len(frames)
    return new_cameras(
        poses=np.stack([f["pose"] for f in frames]),
        intrinsics=np.stack([f["intrinsics"] for f in frames]),
        camera_models=np.full((n,), camera_model_to_int(trajectory["camera_model"]), np.int32),
        image_sizes=np.tile(np.array(trajectory["image_size"], np.int32), (n, 1)),
        distortion_parameters=np.zeros((n, 0), np.float32),
        nears_fars=None, metadata=None)


def trajectory_get_embeddings(method: Method,
                              trajectory: Trajectory) -> Optional[List[np.ndarray]]:
    """Per-frame appearance embeddings: each frame blends the trajectory's
    appearance anchors (an embedding, or a training image's) by its
    `appearance_weights`. None without anchors or without weights."""
    anchors = []
    for appearance in trajectory.get("appearances") or []:
        if appearance.get("embedding") is not None:
            anchors.append(appearance["embedding"])
        elif appearance.get("embedding_train_index") is not None:
            anchors.append(method.get_train_embedding(appearance["embedding_train_index"]))
        else:
            anchors.append(None)
    have_anchor = [a is not None for a in anchors]
    if not any(have_anchor):
        return None
    if not all(have_anchor):
        raise ValueError("Either all embeddings must be provided or all must be missing")
    have_weights = [f.get("appearance_weights") is not None for f in trajectory["frames"]]
    if not any(have_weights):
        return None
    if not all(have_weights):
        raise ValueError("Either all appearance weights must be provided or all must be missing")
    anchor_mat = np.stack(anchors)
    return [f["appearance_weights"] @ anchor_mat for f in trajectory["frames"]]


# ---------------------------------------------------------------------------
# results serialization
# ---------------------------------------------------------------------------

def _encode_values(values: List[float]) -> str:
    return base64.b64encode(np.asarray(values, "<f4").tobytes()).decode("ascii")


def serialize_evaluation_results(metrics: Dict, metrics_lists,
                                 evaluation_protocol: str, nb_info: Dict):
    """Results JSON payload with base64-packed raw per-image metrics
    (reference evaluation.py:626-646)."""
    info = serialize_nb_info(nb_info)
    out = {}
    for promoted in ("render_datetime", "render_dataset_metadata"):
        value = info.pop(promoted, None)
        if value is not None:
            out[promoted] = value
    out.update({
        "nb_info": info,
        "evaluate_datetime": _utc_now(),
        "metrics": {k: round(v, 5) for k, v in metrics.items()},
        "metrics_raw": {k: _encode_values(v) for k, v in metrics_lists.items()},
        "evaluation_protocol": evaluation_protocol,
    })
    return out


def save_evaluation_results(file, metrics: Dict, metrics_lists,
                            evaluation_protocol: str, nb_info: Dict):
    out = serialize_evaluation_results(metrics, metrics_lists,
                                       evaluation_protocol, nb_info)
    if isinstance(file, str):
        if os.path.exists(file):
            raise FileExistsError(f"{file} already exists")
        with open(file, "w", encoding="utf8") as f:
            json.dump(out, f, indent=2)
    else:
        json.dump(out, file, indent=2)
    return out
