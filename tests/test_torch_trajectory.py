"""Trajectory rendering of the port against the JAX package's.

On a small checkpoint (a fabricated reference state imported by the port,
as test_reference_import.py builds one: 40 Gaussians, appearance on, 3
training embeddings), loaded by both packages: `trajectory_get_cameras`
gives the same camera batch, and `trajectory_get_embeddings` the same
per-frame embeddings (two anchors, a training image's and a given one,
blended by each frame's appearance weights). `render_frames` writes 6
frames to a directory and to a .tar.gz, each PNG equal to the port's own
`render` of that camera and embedding in sRGB uint8; a .mp4 raises without
`mediapy`, as in the JAX package.

One test (see test_torch_isolation.py)."""
import os
import sys
import tarfile

import numpy as np
import pytest
import torch

import wildgaussians_tpu.evaluation as jeval
from test_reference_import import _make_reference_state, _write_reference_checkpoint
from wildgaussians_tpu.models.wildgaussians import WildGaussians as JWildGaussians
from wildgaussians_torch import WildGaussians
from wildgaussians_torch import evaluation as teval
from wildgaussians_torch.io.reference_import import import_reference_checkpoint
from wildgaussians_torch.utils import image_to_srgb, read_image

W, H = 48, 32
FRAMES = 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trajectory(rng):
    f = W / 1.2
    frames = []
    for i in range(FRAMES):
        t = i / (FRAMES - 1)
        pose = np.eye(4, dtype=np.float32)[:3].copy()
        pose[0, 3] = 0.3 * (t - 0.5)
        pose[2, 3] = -0.2 * t
        frames.append({"pose": pose, "intrinsics": np.array([f, f, W / 2, H / 2], np.float32),
                       "appearance_weights": np.array([1.0 - t, t], np.float32)})
    return {"camera_model": "pinhole", "image_size": (W, H), "frames": frames, "fps": 10.0,
            "appearances": [{"embedding_train_index": 1},
                            {"embedding": rng.normal(0, 0.05, 32).astype(np.float32)}]}


def test_trajectory_matches_jax(rng, tmp_path, monkeypatch):
    src = _write_reference_checkpoint(str(tmp_path / "ref"), _make_reference_state(rng))
    ckpt = import_reference_checkpoint(src, str(tmp_path / "ckpt"))
    tm = WildGaussians(checkpoint=ckpt, device="cpu")
    jm = JWildGaussians(checkpoint=ckpt)
    traj = _trajectory(rng)

    cams, jcams = teval.trajectory_get_cameras(traj), jeval.trajectory_get_cameras(traj)
    for field in ("poses", "intrinsics", "camera_models", "image_sizes",
                  "distortion_parameters"):
        got, want = getattr(cams, field), getattr(jcams, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert cams.nears_fars is None and len(cams) == FRAMES
    embs = teval.trajectory_get_embeddings(tm, traj)
    jembs = jeval.trajectory_get_embeddings(jm, traj)
    assert len(embs) == len(jembs) == FRAMES
    for got, want in zip(embs, jembs):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(embs[0], tm.get_train_embedding(1))
    no_weights = dict(traj, frames=[{k: v for k, v in f.items() if k != "appearance_weights"}
                                    for f in traj["frames"]])
    assert teval.trajectory_get_embeddings(tm, no_weights) is None

    want = [image_to_srgb(tm.render(cams[i:i + 1], options={"embedding": embs[i]})["color"],
                          np.uint8, color_space="srgb", allow_alpha=True)
            for i in range(FRAMES)]
    assert max(float(np.abs(w.astype(np.float32) - want[0]).max()) for w in want) > 0
    out_dir = tmp_path / "frames"
    teval.render_frames(tm, cams, out_dir, fps=traj["fps"], embeddings=embs)
    assert sorted(os.listdir(out_dir)) == [f"{i:05d}.png" for i in range(FRAMES)]
    for i in range(FRAMES):
        with open(out_dir / f"{i:05d}.png", "rb") as f:
            assert np.array_equal(read_image(f), want[i]), i
    archive = tmp_path / "frames.tar.gz"
    teval.render_frames(tm, cams, archive, fps=traj["fps"], embeddings=embs)
    with tarfile.open(archive, "r:gz") as tar:
        assert sorted(tar.getnames()) == [f"{i:05d}.png" for i in range(FRAMES)]
        for i in range(FRAMES):
            assert np.array_equal(read_image(tar.extractfile(f"{i:05d}.png")), want[i]), i
    monkeypatch.setitem(sys.modules, "mediapy", None)
    with pytest.raises(RuntimeError, match="mediapy"):
        teval.render_frames(tm, cams, tmp_path / "video.mp4", fps=traj["fps"], embeddings=embs)
