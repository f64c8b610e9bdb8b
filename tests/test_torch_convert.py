"""Checkpoint loading: the appearance MLP through `params_from_numpy`
against the JAX package's `apply_mlp` (rtol 1e-5 / atol 1e-5), the shape
checks against the config, and the entry point on a config the port does
not fully serve (uncertainty_mode: dino) and without a card. One test (see
test_torch_isolation.py); each check is a function of its own."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wildgaussians_tpu.config import Config as JConfig
from wildgaussians_tpu.models import appearance as japp
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.config import Config
from wildgaussians_torch.io.convert import params_from_numpy, save_checkpoint
from wildgaussians_torch.types import new_cameras

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _flat_checkpoint(rng, config, capacity=64, num_images=3):
    """A JAX-format flat state (the keys `_state_dict` writes) with the
    appearance MLP from the JAX package's own init."""
    shdim = (config.sh_degree + 1) ** 2
    flat = {
        "params/xyz": rng.normal(size=(capacity, 3)),
        "params/features_dc": rng.uniform(0, 1, (capacity, 3)),
        "params/features_rest": rng.normal(0, 0.1, (capacity, (shdim - 1) * 3)),
        "params/scales": rng.uniform(-4, -2, (capacity, 3)),
        "params/rotations": rng.normal(size=(capacity, 4)),
        "params/opacities": rng.normal(size=(capacity, 1)),
        "params/embeddings": rng.normal(size=(capacity, 6 * config.appearance_n_fourier_freqs)),
        "params/appearance_embeddings": rng.normal(size=(num_images, config.appearance_embedding_dim)),
        "aux/alive": np.ones(capacity, bool),
        "aux/filter_3D": np.zeros((capacity, 1)),
        "aux/active_sh_degree": np.int32(config.sh_degree),
        "adam/step": np.int32(0),
        "spatial_lr_scale": np.float32(1.0),
    }
    flat = {k: np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64 else np.asarray(v)
            for k, v in flat.items()}
    for k, v in japp.init_mlp(rng, JConfig(sh_degree=config.sh_degree)).items():
        flat[f"params/appearance_mlp/{k}"] = np.asarray(v)
    return flat


def _check_appearance_mlp(rng):
    config = Config()
    flat = _flat_checkpoint(rng, config)
    state = params_from_numpy(flat, config, "cpu")
    n = 64
    feats = rng.uniform(-0.5, 1.0, (n, 48)).astype(np.float32)
    aemb = np.broadcast_to(flat["params/appearance_embeddings"][1], (n, 32)).copy()
    jparams = {k.split("/")[-1]: jnp.asarray(v) for k, v in flat.items()
               if k.startswith("params/appearance_mlp/")}
    j = japp.apply_mlp(jparams, jnp.asarray(flat["params/embeddings"]), jnp.asarray(aemb),
                       jnp.asarray(feats))
    with torch.no_grad():
        t = state.mlp(state.params["embeddings"], _t(aemb), _t(feats))
    # the square hidden layer catches a missed [in, out] -> [out, in] transpose
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert state.aux.alive.dtype == torch.bool and int(state.aux.active_sh_degree) == 3


def _check_rejects_config_mismatch(rng, key, config_change):
    flat = _flat_checkpoint(rng, Config())
    if "appearance_embedding_dim" in config_change:
        # keep the stored image embeddings consistent so the MLP width is the fault
        flat["params/appearance_embeddings"] = flat["params/appearance_embeddings"][:, :16]
    if "appearance_n_fourier_freqs" in config_change:
        flat["params/embeddings"] = flat["params/embeddings"][:, :18]
    config = Config(**config_change)
    with pytest.raises(ValueError, match=re.escape(key)):
        params_from_numpy(flat, config, "cpu")


def _check_dino_config_and_device(rng, tmp_path, monkeypatch):
    """A config with uncertainty_mode: dino loads and renders (render never
    uses the uncertainty model, so the port builds none), and without a card
    the entry point raises unless device="cpu" is passed."""
    config = Config(uncertainty_mode="dino")
    flat = _flat_checkpoint(rng, config)
    flat["params/xyz"][:, 2] = np.abs(flat["params/xyz"][:, 2]) + 2.0   # in front of the camera
    save_checkpoint(str(tmp_path), config, flat)
    with open(tmp_path / "config.yaml", encoding="utf8") as f:
        assert yaml.safe_load(f)["uncertainty_mode"] == "dino"
    model = WildGaussians(checkpoint=str(tmp_path), device="cpu")
    cam = new_cameras(poses=np.eye(4, dtype=np.float32)[None, :3],
                      intrinsics=np.array([[35.0, 35.0, 20.0, 15.0]], np.float32),
                      camera_models=np.zeros((1,), np.int32),
                      distortion_parameters=np.zeros((1, 6), np.float32),
                      image_sizes=np.array([[40, 30]], np.int32))
    out = model.render(cam)
    assert out["color"].shape == (30, 40, 3) and np.isfinite(out["color"]).all()
    assert out["accumulation"].max() > 0 and "depth" not in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WildGaussians(checkpoint=str(tmp_path))


def test_checkpoint_loading(tmp_path, monkeypatch):
    _check_appearance_mlp(np.random.default_rng(42))
    for key, config_change in (("params/features_rest", {"sh_degree": 2}),
                               ("params/appearance_mlp/w0", {"appearance_embedding_dim": 16}),
                               ("params/appearance_mlp/w0", {"appearance_n_fourier_freqs": 3})):
        _check_rejects_config_mismatch(np.random.default_rng(42), key, config_change)
    _check_dino_config_and_device(np.random.default_rng(42), tmp_path, monkeypatch)
