"""The port's dataset loaders against the JAX package's, on scenes written to
disk: a COLMAP scene from `make_colmap_scene` (tests/test_datasets_cli.py)
in binary, the same model in text (`{train,test}_list.txt` beside it), and
a Photo Tourism layout (`phototourism/brandenburg-gate/{images,sparse}`,
`nerfw_split.csv`, images of two sizes, one camera per size).

For both splits of each: `load_dataset`, `load_colmap_dataset` or
`load_phototourism_dataset`, `dataset_load_features` and
`horizontal_half_dataset` (both halves) give equal datasets, exactly:
every camera array, image, mask, path, point and metadata entry. Also:
the bulk `points3D.bin` writer gives the per-point writer's bytes; and
`external://` on an empty cache raises DatasetNotFoundError and opens no
socket, and a Photo Tourism scene missing from the cache does the same
through `download_phototourism_dataset`. (The card has PIL, so the port
decodes images with it, as the JAX package does.)

One test (see test_torch_isolation.py)."""
import shutil
import socket

import numpy as np
import pytest

import wildgaussians_tpu.datasets as jdatasets
import wildgaussians_tpu.datasets.colmap as jcolmap
import wildgaussians_tpu.datasets.colmap_utils as jcolmap_utils
import wildgaussians_tpu.datasets.phototourism as jpt
import wildgaussians_torch.datasets as tdatasets
import wildgaussians_torch.datasets.colmap as tcolmap
import wildgaussians_torch.datasets.phototourism as tpt
from test_datasets_cli import make_colmap_scene
from wildgaussians_torch.datasets.colmap_utils import (Camera, Image, Point3D, read_model,
                                                       write_cameras_binary, write_images_binary,
                                                       write_model, write_points3D_arrays_binary,
                                                       write_points3D_binary)

FEATURES = frozenset(("color", "points3D_xyz", "points3D_rgb"))


def _equal(a, b, where):
    """Exact equality of two datasets' values (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), f"{where}: keys {a.keys()} {b.keys()}"
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif hasattr(a, "poses") and hasattr(a, "image_sizes"):       # Cameras
        for field in ("poses", "intrinsics", "camera_models", "distortion_parameters",
                      "image_sizes", "nears_fars", "metadata"):
            _equal(getattr(a, field), getattr(b, field), f"{where}.{field}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{where}: lengths"
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), f"{where}: {a!r} {b!r}"


def _text_scene(src, dst):
    """The binary scene `src` as a text model in `dst`, with split lists
    (images 1 and 4 are the test split)."""
    (dst / "sparse" / "0").mkdir(parents=True)
    write_model(*read_model(src / "sparse"), dst / "sparse" / "0", ext=".txt")
    shutil.copytree(src / "images", dst / "images")
    names = sorted(p.name for p in (src / "images").iterdir())
    test = {names[1], names[4]}
    (dst / "test_list.txt").write_text("\n".join(sorted(test)))
    (dst / "train_list.txt").write_text("\n".join(n for n in names if n not in test))
    return dst


def _phototourism_scene(src, root):
    """`src`'s model and images as a Photo Tourism capture whose odd images
    are half the width and a camera of their own (two image sizes), with a
    NeRF-W split list (images 2 and 5 the test split)."""
    from PIL import Image as PILImage
    scene = root / "phototourism" / "brandenburg-gate"
    (scene / "sparse").mkdir(parents=True)
    shutil.copytree(src / "images", scene / "images")
    cams, imgs, pts = read_model(src / "sparse")
    cam = cams[1]
    fx, fy, cx, cy = cam.params
    w2 = cam.width // 2 + 3
    cams[2] = Camera(2, "PINHOLE", w2, cam.height, np.array([fx, fy, w2 / 2, cy]))
    for k, im in list(imgs.items()):
        if k % 2 == 0:
            imgs[k] = Image(im.id, im.qvec, im.tvec, 2, im.name, im.xys, im.point3D_ids)
            path = scene / "images" / im.name
            PILImage.fromarray(np.asarray(PILImage.open(path))[:, :w2]).save(path)
    write_cameras_binary(cams, scene / "sparse" / "cameras.bin")
    write_images_binary(imgs, scene / "sparse" / "images.bin")
    shutil.copy(src / "sparse" / "points3D.bin", scene / "sparse" / "points3D.bin")
    names = [imgs[k].name for k in sorted(imgs)]
    rows = ["filename\tid\tsplit\tdataset"] + [
        f"{n}\t{i}\t{'test' if i in (2, 5) else 'train'}\tbrandenburg"
        for i, n in enumerate(names)]
    (scene / "nerfw_split.csv").write_text("\n".join(rows) + "\n")
    return scene


def _both(fn_j, fn_t, *args, **kwargs):
    return fn_j(*args, **kwargs), fn_t(*args, **kwargs)


def _check_loaded(j, t, where, halves=True):
    _equal(j, t, f"{where} (unloaded)")
    j, t = jdatasets.dataset_load_features(j), tdatasets.dataset_load_features(t)
    _equal(j, t, f"{where} (loaded)")
    assert len(t["images"]) == len(t["cameras"]) > 0
    if halves:
        for left in (True, False):
            _equal(jpt.horizontal_half_dataset(j, left=left),
                   tpt.horizontal_half_dataset(t, left=left), f"{where} (half, left={left})")


def _check_points_writer(tmp_path, rng):
    """The bulk points3D.bin writer against the per-point one, read back by
    the JAX package."""
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    write_points3D_arrays_binary(xyz, rgb, tmp_path / "bulk.bin")
    none = np.zeros((0,), np.int32)
    write_points3D_binary({i + 1: Point3D(i + 1, xyz[i], rgb[i], 0.0, none, none)
                           for i in range(len(xyz))}, tmp_path / "each.bin")
    assert (tmp_path / "bulk.bin").read_bytes() == (tmp_path / "each.bin").read_bytes()
    points = jcolmap_utils.read_points3D_binary(tmp_path / "bulk.bin")
    assert list(points) == list(range(1, len(xyz) + 1))
    assert np.array_equal(np.stack([p.xyz for p in points.values()]), xyz)
    assert np.array_equal(np.stack([p.rgb for p in points.values()]), rgb)


def _check_no_network(monkeypatch, tmp_path):
    """`external://` on an empty cache raises without opening a socket."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a network connection was attempted")
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setenv("WG_PREFIX", str(tmp_path / "empty-cache"))
    for name in ("phototourism/brandenburg-gate", "mipnerf360/garden"):
        with pytest.raises(tdatasets.DatasetNotFoundError):
            tdatasets.load_dataset(f"external://{name}", split="train", features=FEATURES)
    with pytest.raises(tdatasets.DatasetNotFoundError, match="nothing is downloaded"):
        tpt.download_phototourism_dataset("phototourism/trevi-fountain",
                                          tmp_path / "empty-cache" / "trevi")


def test_datasets_match_jax(tmp_path, rng, monkeypatch):
    binary = make_colmap_scene(tmp_path / "colmap", rng, n_cams=9, n_points=60)
    text = _text_scene(binary, tmp_path / "colmap-text")
    pt = _phototourism_scene(binary, tmp_path / "cache")
    for split in ("train", "test"):
        _check_loaded(*_both(jcolmap.load_colmap_dataset, tcolmap.load_colmap_dataset,
                             binary, split=split, features=FEATURES), f"colmap {split}")
        _check_loaded(*_both(jdatasets.load_dataset, tdatasets.load_dataset,
                             text, split, features=FEATURES), f"colmap text {split}")
        j, t = _both(jpt.load_phototourism_dataset, tpt.load_phototourism_dataset, pt,
                     split=split, features=FEATURES)
        assert len(t["image_paths"]) == (2 if split == "test" else 7)
        assert len({tuple(s) for s in t["cameras"].image_sizes}) == 2
        _check_loaded(j, t, f"phototourism {split}")
        _check_loaded(*_both(jdatasets.load_dataset, tdatasets.load_dataset, pt, split,
                             features=FEATURES), f"phototourism via load_dataset {split}",
                      halves=False)
    # the whole scene, no split and no points (the loader's other branch)
    _check_loaded(*_both(jcolmap.load_colmap_dataset, tcolmap.load_colmap_dataset, binary),
                  "colmap, no split", halves=False)
    _check_points_writer(tmp_path, rng)
    _check_no_network(monkeypatch, tmp_path)
