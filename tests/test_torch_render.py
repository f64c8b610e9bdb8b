"""The whole serving slice: a JAX-format checkpoint loaded by the JAX package
and by the port, rendered through `WildGaussians.render` by both. The
port-only checks of the entry point (a dino config renders, no card raises)
are in test_torch_convert.py.

One test (see test_torch_isolation.py)."""
import os

import numpy as np
import pytest
import torch

from wildgaussians_tpu.config import Config as JConfig, config_to_yaml
from wildgaussians_tpu.models import appearance as japp
from wildgaussians_tpu.models import gaussian_store as jgs
from wildgaussians_tpu.models.wildgaussians import WildGaussians as JWildGaussians
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.types import new_cameras

C0 = 0.28209479177387814
ATOL = 1e-4      # color and accumulation
DEPTH_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_checkpoint(path, rng, *, n=200, capacity=224, num_images=4, **config_fields):
    """A checkpoint in the JAX package's format (`_state_dict` keys +
    config.yaml): SH degree 3, appearance on, some dead slots, a non-zero
    3D filter, non-trivial features_rest and embeddings."""
    config = JConfig(**config_fields)
    shdim = (config.sh_degree + 1) ** 2
    f32 = np.float32
    z = rng.uniform(2.0, 7.0, capacity)
    xyz = np.stack([rng.uniform(-1, 1, capacity) * z * 0.55,
                    rng.uniform(-1, 1, capacity) * z * 0.4, z], -1)
    params = {
        "xyz": xyz.astype(f32),
        "features_dc": ((rng.uniform(0, 1, (capacity, 3)) - 0.5) / C0).astype(f32),
        "features_rest": rng.normal(0, 0.08, (capacity, (shdim - 1) * 3)).astype(f32),
        "scales": np.log(z[:, None] * rng.uniform(0.004, 0.03, (capacity, 3))).astype(f32),
        "rotations": rng.normal(size=(capacity, 4)).astype(f32),
        "opacities": rng.normal(0.5, 1.5, (capacity, 1)).astype(f32),
        "embeddings": rng.normal(0, 1, (capacity, 6 * config.appearance_n_fourier_freqs)).astype(f32),
        "appearance_embeddings": rng.normal(0, 0.5, (num_images, config.appearance_embedding_dim)).astype(f32),
        "appearance_mlp": {k: np.asarray(v) for k, v in japp.init_mlp(rng, config).items()},
    }
    flat = {}

    def add(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                add(f"{prefix}{k}/", v)
            else:
                flat[prefix + k] = v
    add("params/", params)
    add("adam/mu/", params)
    add("adam/nu/", params)
    flat["adam/step"] = np.asarray(10, np.int32)
    aux = {f: np.zeros((capacity, 1), f32) for f in jgs.AuxState._fields}
    aux["alive"] = np.arange(capacity) < n
    aux["filter_3D"] = rng.uniform(0.0, 0.01, (capacity, 1)).astype(f32)
    aux["max_radii2D"] = np.zeros((capacity,), f32)
    aux["active_sh_degree"] = np.asarray(config.sh_degree, np.int32)
    for k, v in aux.items():
        flat[f"aux/{k}"] = v
    flat["spatial_lr_scale"] = np.asarray(1.0, f32)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "chkpnt-30.npz"), **flat)
    with open(os.path.join(path, "config.yaml"), "w", encoding="utf8") as f:
        f.write(config_to_yaml(config))
    return flat


def _camera(w=70, h=45):
    f = w / (2 * np.tan(np.radians(60.0) / 2))
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[:, 3] = [0.05, -0.03, -0.2]
    return new_cameras(poses=pose[None], intrinsics=np.array([[f, f * 1.02, w / 2 + 0.3, h / 2 - 0.2]], np.float32),
                       camera_models=np.zeros((1,), np.int32),
                       distortion_parameters=np.zeros((1, 6), np.float32),
                       image_sizes=np.array([[w, h]], np.int32))


def test_render_matches_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    flat = _write_checkpoint(str(tmp_path), rng, uncertainty_mode="disabled",
                             rasterizer_backend="pallas", pallas_pack16=False)
    cam = _camera()
    jmodel = JWildGaussians(checkpoint=str(tmp_path))
    tmodel = WildGaussians(checkpoint=str(tmp_path), device="cpu")
    emb = 40.0 * flat["params/appearance_embeddings"][2]   # far from the zero default
    np.testing.assert_array_equal(tmodel.get_train_embedding(2), jmodel.get_train_embedding(2))
    # the JAX side renders with depth only (one compiled program): its extra
    # pass shares T with the others, so its color and accumulation are those
    # of a render without options
    j_default = jmodel.render(cam, options={"outputs": ["depth"]})
    t_default = tmodel.render(cam)
    j_emb = jmodel.render(cam, options={"outputs": ["depth"], "embedding": emb})
    t_emb = tmodel.render(cam, options={"outputs": ["depth"], "embedding": emb})
    assert set(t_default) == {"color", "accumulation"} and set(t_emb) == set(j_emb)
    assert np.abs(j_emb["color"] - j_default["color"]).max() > 1e-2
    for j, t in ((j_default, t_default), (j_emb, t_emb)):
        assert t["color"].shape == (45, 70, 3)
        assert 0.05 < j["accumulation"].mean() < 0.99
        np.testing.assert_allclose(t["color"], j["color"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(t["accumulation"], j["accumulation"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_emb["depth"], j_emb["depth"], rtol=DEPTH_RTOL,
                               atol=DEPTH_RTOL * float(j_emb["depth"].max()))
