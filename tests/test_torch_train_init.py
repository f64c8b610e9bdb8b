"""Training starts where the JAX package starts: from one seed, point cloud
and camera set, the port's sky points, `init_params_from_points` and
`init_mlp` (drawn from one numpy generator in the JAX package's order) give
bit-identical arrays, and `compute_3d_filter` and the camera extent agree.
`mean_knn_dist2` (the Morton-window 3-NN, plain torch) is held against the
JAX trainer's default with rtol 1e-6: the native simple-knn
(`wildgaussians_tpu/ops/knn_native.py`) when g++ can build it, as the
trainer picks it, else `wildgaussians_tpu/ops/knn.py` (the native build may
contract a sum of three squares into FMAs); the init checks hand both sides
the JAX result, as the trainer tests do.

One test (see test_torch_isolation.py)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu
from helpers import make_scene
from wildgaussians_tpu.cameras import get_cameras_extent as jextent
from wildgaussians_tpu.config import load_config_yaml as jload, merge_config as jmerge
from wildgaussians_tpu.models import appearance as japp
from wildgaussians_tpu.models import gaussian_store as jgs
from wildgaussians_tpu.models.sky import get_sky_points as jsky
from wildgaussians_tpu.ops import knn_native
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch.cameras import get_cameras_extent
from wildgaussians_torch.config import load_config_yaml, merge_config
from wildgaussians_torch.models import gaussian_store as gs
from wildgaussians_torch.models.appearance import AppearanceMLP
from wildgaussians_torch.models.sky import get_sky_points
from wildgaussians_torch.ops.knn import mean_knn_dist2
from wildgaussians_torch.types import new_cameras

OVERRIDES = dict(uncertainty_mode="disabled", num_sky_gaussians=3000)
KNN_RTOL = 1e-6
FILTER_RTOL = 1e-6   # a 4x4 inverse through two LAPACK builds


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cameras(make, n_cams=4, width=64, height=48):
    poses = []
    for i in range(n_cams):
        angle = (i - n_cams / 2) * 0.08
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = np.sin(angle) * 4.0
        pose[2, 3] = 5.0 - np.cos(angle) * 5.0
        c, s = np.cos(angle * 0.5), np.sin(angle * 0.5)
        pose[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        poses.append(pose)
    f = width / (2 * np.tan(np.radians(50.0) / 2))
    return make(poses=np.stack(poses), intrinsics=np.array([[f, f, width / 2, height / 2]] * n_cams,
                                                           np.float32),
                camera_models=np.zeros((n_cams,), np.int32),
                distortion_parameters=np.zeros((n_cams, 6), np.float32),
                image_sizes=np.array([[width, height]] * n_cams, np.int32))


def _configs():
    jdir = os.path.join(os.path.dirname(wildgaussians_tpu.__file__), "configs")
    tdir = os.path.join(os.path.dirname(gs.__file__), "..", "configs")
    return (jmerge(jload(os.path.join(jdir, "default.yml")), dict(OVERRIDES)),
            merge_config(load_config_yaml(os.path.join(tdir, "default.yml")), dict(OVERRIDES)))


def test_train_init_matches_jax():
    jconfig, config = _configs()
    assert (config.sh_degree, config.appearance_enabled, config.seed) == \
        (jconfig.sh_degree, jconfig.appearance_enabled, jconfig.seed)
    rng = np.random.default_rng(11)
    xyz = make_scene(rng, n=400, spread=1.5, z_range=(3.0, 7.0))["xyz"]
    rgb = rng.integers(0, 256, (400, 3)).astype(np.uint8)
    jcams, cams = _cameras(jcameras), _cameras(new_cameras)

    # sky points (host numpy) and the camera extent
    jsk, jdist = jsky(config.num_sky_gaussians, xyz, jcams)
    sk, dist = get_sky_points(config.num_sky_gaussians, xyz, cams)
    assert sk.shape[0] > 0 and np.array_equal(sk, jsk) and dist == jdist
    assert get_cameras_extent(cams) == jextent(jcams)
    pts = np.concatenate([xyz, sk])
    cols = np.concatenate([rgb, np.array([[237, 247, 252]], np.uint8).repeat(len(sk), 0)])
    opac = np.concatenate([0.1 * np.ones(len(xyz), np.float32), np.ones(len(sk), np.float32)])

    # the Morton-window 3-NN, against the one the JAX trainer picks
    if knn_native.available():
        knn_d2 = knn_native.mean_knn_dist2_native(pts.astype(np.float32))
    else:
        knn_d2 = np.asarray(jknn(jnp.asarray(pts)))
    np.testing.assert_allclose(mean_knn_dist2(torch.tensor(pts)).numpy(), knn_d2,
                               rtol=KNN_RTOL, atol=0)

    # parameters and MLP from one generator, in the JAX package's order
    capacity = ((int(len(pts) * 1.5) + 255) // 256) * 256   # the trainer's default
    jrng, trng = np.random.default_rng(config.seed), np.random.default_rng(config.seed)
    with np.errstate(divide="ignore"):   # the sky's opacity 1 has logit +inf, as in JAX
        jparams, jaux = jgs.init_params_from_points(jconfig, pts, cols, opac, capacity,
                                                    len(jcams), knn_d2, jrng)
        params, aux = gs.init_params_from_points(config, pts, cols, opac, capacity,
                                                 len(cams), knn_d2, trng)
    jparams["appearance_mlp"] = japp.init_mlp(jrng, jconfig)
    mlp = AppearanceMLP.from_config(config, trng)
    assert sorted(params) == sorted(k for k in jparams if k != "appearance_mlp")
    for k, v in params.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(jparams[k])), k
    for k, v in mlp.named_tensors().items():
        v = v.detach().numpy()
        want = np.asarray(jparams["appearance_mlp"][k.split("/")[1]])
        assert np.array_equal(v.T if k.startswith("appearance_mlp/w") else v, want), k
    assert np.array_equal(aux.alive.numpy(), np.asarray(jaux.alive))
    assert jrng.random() == trng.random()   # both generators drew as much

    # the 3D filter from the cameras
    poses = np.stack([np.asarray(p, np.float32) for p in cams.poses])
    intr = np.asarray(cams.intrinsics, np.float32)
    sizes = np.asarray(cams.image_sizes, np.float32)
    jf = np.asarray(jgs.compute_3d_filter(jnp.asarray(jparams["xyz"]), jnp.asarray(jaux.alive),
                                          jnp.asarray(poses), jnp.asarray(intr),
                                          jnp.asarray(sizes)))
    tf = gs.compute_3d_filter(params["xyz"], aux.alive, torch.tensor(poses), torch.tensor(intr),
                              torch.tensor(sizes)).numpy()
    np.testing.assert_allclose(tf, jf, rtol=FILTER_RTOL, atol=0)
