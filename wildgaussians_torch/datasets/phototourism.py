"""Photo Tourism dataset and the NeRF-W evaluation protocol.

The port's copy of `wildgaussians_tpu/datasets/phototourism.py`, except that
nothing is downloaded: `download_phototourism_dataset` finds a scene already
in place or raises DatasetNotFoundError.
"""
import csv
import logging
from pathlib import Path
from typing import Dict, Iterable, Union, cast

import numpy as np

from ..spans import span
from ..types import Dataset, EvaluationProtocol, Method, RenderOutput
from ..utils import image_to_srgb
from .colmap import load_colmap_dataset
from .common import (DatasetNotFoundError, dataset_index_select,
                     get_default_viewer_transform, get_scene_scale, single)

logger = logging.getLogger(__name__)

DATASET_NAME = "phototourism"

# Scene registry (reference phototourism.py:88-111). The URLs name the
# archives a user fetches and unpacks into the cache by hand; the port never
# opens them.
_phototourism_downloads = {
    "brandenburg-gate": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/brandenburg_gate.tar.gz",
    "buckingham-palace": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/buckingham_palace.tar.gz",
    "colosseum-exterior": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/colosseum_exterior.tar.gz",
    "grand-palace-brussels": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/grand_place_brussels.tar.gz",
    "notre-dame-facade": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/notre_dame_front_facade.tar.gz",
    "westminster-palace": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/palace_of_westminster.tar.gz",
    "pantheon-exterior": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/pantheon_exterior.tar.gz",
    "taj-mahal": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/taj_mahal.tar.gz",
    "temple-nara": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/temple_nara_japan.tar.gz",
    "trevi-fountain": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/trevi_fountain.tar.gz",
    "sacre-coeur": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/sacre_coeur.tar.gz",
    "hagia-sophia": "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/hagia_sophia.tar.gz",
}

_split_lists = {
    "brandenburg-gate": "https://nerf-w.github.io/data/selected_images/brandenburg.tsv",
    "trevi-fountain": "https://nerf-w.github.io/data/selected_images/trevi.tsv",
    "sacre-coeur": "https://nerf-w.github.io/data/selected_images/sacre.tsv",
    "hagia-sophia": "https://nerf-w.github.io/data/selected_images/hagia.tsv",
    "taj-mahal": "https://nerf-w.github.io/data/selected_images/taj_mahal.tsv",
}


def load_phototourism_dataset(path: Union[Path, str], split: str,
                              use_nerfw_split=None, **kwargs):
    """reference phototourism.py:22-81."""
    path = Path(path)
    use_nerfw_split = use_nerfw_split if use_nerfw_split is not None else True
    if split:
        assert split in {"train", "test"}
    if DATASET_NAME not in str(path) or not any(
            s in str(path) for s in _phototourism_downloads):
        raise DatasetNotFoundError(
            f"{set(_phototourism_downloads.keys())} is missing from the dataset path: {path}")

    scene = single(res for res in _phototourism_downloads if str(res) in path.name)
    split_list = None
    if use_nerfw_split:
        if (path / "nerfw_split.csv").exists():
            with (path / "nerfw_split.csv").open() as f:
                reader = csv.reader(f, delimiter="\t")
                next(reader)
                split_list = [x[0] for x in reader if x[1] and x[2] == split]
                assert len(split_list) > 0, f"{split} list is empty"
        else:
            logger.warning("NeRF-W test list not found for %s/%s. Using a standard split.",
                           DATASET_NAME, scene)

    dataset = load_colmap_dataset(path, images_path="images", colmap_path="sparse",
                                  split=None, **kwargs)
    dataset["metadata"]["id"] = DATASET_NAME
    dataset["metadata"]["scene"] = scene
    dataset["metadata"]["expected_scene_scale"] = get_scene_scale(dataset["cameras"], None)
    dataset["metadata"]["type"] = None
    dataset["metadata"]["evaluation_protocol"] = "nerfw"
    viewer_transform, viewer_pose = get_default_viewer_transform(
        dataset["cameras"].poses, None)
    dataset["metadata"]["viewer_transform"] = viewer_transform
    dataset["metadata"]["viewer_initial_pose"] = viewer_pose

    dataset_len = len(dataset["image_paths"])
    if split_list is not None:
        indices = np.array([i for i, x in enumerate(dataset["image_paths"])
                            if Path(x).name in split_list])
        assert len(indices) > 0, f"No images found in {split} list"
        logger.info("Using %d/%d images from the NeRF-W %s list", len(indices),
                    dataset_len, split)
    else:
        all_indices = np.arange(dataset_len)
        llffhold = 8
        if split == "train":
            indices = all_indices % llffhold != 0
        else:
            indices = all_indices % llffhold == 0
    return dataset_index_select(dataset, indices)


def download_phototourism_dataset(path: str, output: Union[Path, str]):
    """Make sure a Photo Tourism capture is in `output`: `path` is
    'phototourism' (every scene with a NeRF-W split list) or
    'phototourism/<scene>'. Nothing is downloaded: a scene missing from
    `output` raises DatasetNotFoundError, which names the archive to unpack
    there (its dense/ subtree) and the NeRF-W split list to save as
    nerfw_split.csv."""
    output = Path(output)
    if path != DATASET_NAME and not path.startswith(f"{DATASET_NAME}/"):
        raise DatasetNotFoundError(
            f"Dataset path must be '{DATASET_NAME}' or start with '{DATASET_NAME}/'")
    if path == DATASET_NAME:
        for scene in _split_lists:
            download_phototourism_dataset(f"{DATASET_NAME}/{scene}", output / scene)
        return
    scene = path.split("/", 1)[1]
    if scene not in _phototourism_downloads:
        raise DatasetNotFoundError(
            f"Capture '{scene}' is not a valid {DATASET_NAME} scene")
    if output.exists():
        logger.info("Dataset %s already exists in %s", path, output)
        return
    split = (f" and save {_split_lists[scene]} as {output / 'nerfw_split.csv'}"
             if scene in _split_lists else "")
    raise DatasetNotFoundError(
        f"{path} is not in the local cache ({output}); nothing is downloaded: unpack the "
        f"dense/ folder of {_phototourism_downloads[scene]} into {output}{split}")


def horizontal_half_dataset(dataset: Dataset, left: bool = True) -> Dataset:
    """Split each image into left/right halves by shifting cx
    (reference phototourism.py:191-212)."""
    intrinsics = dataset["cameras"].intrinsics.copy()
    image_sizes = dataset["cameras"].image_sizes.copy()
    image_sizes[:, 0] //= 2
    if left:
        image_sizes[:, 0] = dataset["cameras"].image_sizes[:, 0] - image_sizes[:, 0]
    if not left:
        intrinsics[:, 2] -= image_sizes[:, 0]

    def get_slice(img, w):
        return img[:, :w] if left else img[:, -w:]

    out = dict(dataset)
    out.update(dict(
        cameras=dataset["cameras"].replace(intrinsics=intrinsics, image_sizes=image_sizes),
        images=[get_slice(img, w) for img, w in zip(dataset["images"], image_sizes[:, 0])],
        masks=([get_slice(m, w) for m, w in zip(dataset["masks"], image_sizes[:, 0])]
               if dataset["masks"] is not None else None),
    ))
    return cast(Dataset, out)


class NerfWEvaluationProtocol(EvaluationProtocol):
    """Optimize the appearance embedding on the left half, evaluate on the
    right half (reference phototourism.py:215-251)."""

    def __init__(self):
        from ..evaluation import compute_metrics
        self._compute_metrics = compute_metrics

    def get_name(self):
        return "nerfw"

    def render(self, method: Method, dataset: Dataset) -> RenderOutput:
        optimization_dataset = horizontal_half_dataset(dataset, left=True)
        embedding = None
        try:
            with span("embedding_fit"):
                pred = method.optimize_embedding(optimization_dataset)
            embedding = pred["embedding"]
        except NotImplementedError:
            pass
        return method.render(dataset["cameras"].item(), options={"embedding": embedding})

    def evaluate(self, predictions: RenderOutput, dataset: Dataset) -> Dict[str, Union[float, int]]:
        assert len(dataset["images"]) == 1, "Only single image evaluation is supported"
        gt = dataset["images"][0]
        color = predictions["color"]
        background_color = dataset["metadata"].get("background_color", None)
        color_srgb = image_to_srgb(color, np.uint8, color_space="srgb",
                                   background_color=background_color)
        gt_srgb = image_to_srgb(gt, np.uint8, color_space="srgb",
                                background_color=background_color)
        w = gt_srgb.shape[1]
        return self._compute_metrics(color_srgb[:, (w // 2):], gt_srgb[:, (w // 2):])

    def accumulate_metrics(self, metrics: Iterable[Dict[str, Union[float, int]]]):
        acc: Dict[str, Union[float, int]] = {}
        for i, data in enumerate(metrics):
            for k, v in data.items():
                acc[k] = (acc.get(k, 0) * i + v) / (i + 1)
        return acc
