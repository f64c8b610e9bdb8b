"""The saturation cull of the port against the JAX package's.

On the occluded scene of test_satcull.py (five opaque wall layers in front
of a far field, 64x64): the JAX sort engine (`rasterize_pallas_multi`,
`pack16=False`, its kernels in interpret mode) and the port's (its plain K1
on the CPU) give the same per-tile saturation depths (bit for bit, +inf
where a tile did not saturate), the same pooled supertile map, the same
visible-cell counts under it and images within TOL_IMG; a +inf map is the
identity bit for bit; the cull fires and leaves the image within 5e-3 (the
JAX test's bound); a stale map over a thinned wall gives back a +inf map,
and the next render is exact again.

Then training: `saturation_culling: true` on the pallas backend, 10 steps
over 4 cameras (camera = step mod 4, a densify at iteration 6 and an
opacity reset at 9), each side from the JAX trainer's state before the
step (carried into the port), so that each step's loss is compared alone:
losses to rtol 1e-5, and after every step the trainers' saturation maps per
canvas and camera are equal, cleared after the densify and the reset, and
culled the binning of the steps that revisit a camera (iterations 5 and 6).

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.cameras as jcameras
import wildgaussians_tpu.models.wildgaussians as jwg
import wildgaussians_tpu.ops.knn_native as jknn_native
from helpers import make_camera
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.gaussians import compute_cov3d as jcov3d
from wildgaussians_tpu.ops.gaussians import preprocess as jpreprocess
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_tpu.types import new_cameras as jnew_cameras
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.io.convert import train_state_from_numpy
import wildgaussians_torch.models.wildgaussians as twg
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import sort_engine as tsort
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.types import new_cameras

W = H = 64
D_MAX = 16
TOL_IMG = 1e-5        # the partition-engine test's image tolerance
TOL_CULL = 5e-3       # the JAX test's bound on what the cull may change
LOSS_RTOL = 1e-5
OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas", pallas_pack16=False,
                 saturation_culling=True, num_sky_gaussians=0, max_tiles_per_gaussian=8,
                 pallas_big_fraction=0.5, densify_from_iter=1, densification_interval=6,
                 opacity_reset_interval=9, initial_capacity=4096, sh_degree=0)
STEPS = 10
N_CAMS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _occluded_scene(rng, wall_opacity=0.99):
    """tests/test_satcull.py's scene: 5 wall layers at z 4.6-5.4 covering
    the frame, 200 far points at z = 20 behind them."""
    layers = []
    for z in (4.6, 4.8, 5.0, 5.2, 5.4):
        ext = z * 0.75
        xs, ys = np.meshgrid(np.linspace(-ext, ext, 16), np.linspace(-ext, ext, 16))
        layers.append(np.stack([xs.ravel(), ys.ravel(), np.full(256, z)], -1))
    wall = np.concatenate(layers).astype(np.float32)
    far = np.stack([rng.uniform(-12, 12, 200), rng.uniform(-12, 12, 200),
                    np.full(200, 20.0)], -1).astype(np.float32)
    xyz = np.concatenate([wall, far])
    n = xyz.shape[0]
    scales = np.full((n, 3), 0.5, np.float32)
    scales[len(wall):] = 0.6
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = np.full((n,), wall_opacity, np.float32)
    opac[len(wall):] = 0.9
    colors = np.zeros((n, 3), np.float32)
    colors[:len(wall), 0] = 0.9
    colors[len(wall):, 2] = 0.9
    return xyz, scales, rots, opac, colors


def _jax_render(scene, sat_super=None):
    xyz, scales, rots, opac, colors = map(jnp.asarray, scene)
    cam, _w, _h = jcameras.make_camera_params(make_camera(width=W, height=H))
    grid = jmake_grid(W, H, 16)
    pre = jpreprocess(xyz, jcov3d(scales, rots), opac, cam, W, H, 0.1, tile_size=16)
    tt = jnp.minimum(pre.tiles_touched, D_MAX)
    sat = None if sat_super is None else jnp.asarray(sat_super.numpy())
    outs, aux = jpal.rasterize_pallas_multi(
        pre.mean2d, pre.conic, pre.opacity, [colors], jnp.zeros((xyz.shape[0], 2)), pre.depth,
        pre.rect_min, pre.rect_max, tt, pre.valid, jnp.zeros((3,)), grid=grid, chunk=256,
        max_tiles_per_gaussian=D_MAX, d_small=4, big_fraction=0.5, pack16=False,
        return_aux=True, sat_super=sat)
    vis = jpal.visible_cell_counts(pre.mean2d, pre.conic, pre.opacity, pre.rect_min,
                                   pre.rect_max, tt, pre.valid, grid, D_MAX,
                                   sat_super=sat, depth=pre.depth)
    return np.asarray(outs[0][0]), np.asarray(aux["sat_depth"]), np.asarray(vis)


def _port_render(scene, sat_super=None):
    xyz, scales, rots, opac, colors = map(torch.tensor, scene)
    cam, _w, _h = make_camera_params(make_camera(width=W, height=H))
    grid = make_grid(W, H, 16)
    with torch.no_grad():
        pre = preprocess(xyz, compute_cov3d(scales, rots), opac, cam, W, H, 0.1, tile_size=16)
        (out,), aux = tblend.rasterize_multi(
            pre.mean2d, pre.conic, pre.opacity, [colors], pre.depth, pre.rect_min,
            pre.rect_max, pre.tiles_touched, pre.valid, torch.zeros(3), grid=grid,
            max_tiles_per_gaussian=D_MAX, d_small=4, big_fraction=0.5, sat_super=sat_super)
        vis = tsort.visible_cell_counts(pre.mean2d, pre.conic, pre.opacity, pre.rect_min,
                                        pre.rect_max, torch.clamp_max(pre.tiles_touched, D_MAX),
                                        pre.valid, grid, D_MAX, sat_super=sat_super,
                                        depth=pre.depth)
    assert torch.equal(vis, aux["vis_count"])
    return out[0], aux, vis


def _check_render(scene, sat_super=None):
    """The two renders under one map: (port image, port aux, port
    visible-cell counts) after holding them against the JAX ones."""
    jimg, jsat, jvis = _jax_render(scene, sat_super)
    img, aux, vis = _port_render(scene, sat_super)
    np.testing.assert_array_equal(aux["sat_depth"].numpy(), jsat)
    np.testing.assert_array_equal(vis.numpy(), jvis)
    np.testing.assert_allclose(img.numpy(), jimg, atol=TOL_IMG, rtol=0)
    return img, aux, vis


def _check_cull(rng):
    scene = _occluded_scene(rng)
    grid, jgrid = make_grid(W, H, 16), jmake_grid(W, H, 16)
    img0, aux0, vis0 = _check_render(scene)
    sat = aux0["sat_depth"].numpy()
    assert np.isfinite(sat).any() and 4.0 < sat[np.isfinite(sat)].min() \
        and sat[np.isfinite(sat)].max() < 20.0, sat
    pooled = tsort.pool_sat_depth(aux0["sat_depth"], grid, margin=1.25)
    np.testing.assert_array_equal(
        pooled.numpy(), np.asarray(jpal.pool_sat_depth(jnp.asarray(sat), jgrid, margin=1.25)))
    assert tuple(pooled.shape) == tsort.supertile_shape(grid) == jpal.supertile_shape(jgrid)

    # a +inf map changes nothing, bit for bit
    inf_map = torch.full(tsort.supertile_shape(grid), torch.inf)
    img_inf, aux_inf, vis_inf = _port_render(scene, inf_map)
    assert torch.equal(img_inf, img0) and torch.equal(vis_inf, vis0)
    for k in ("table", "tile_starts", "sorted_flat", "walked", "saturated", "sat_depth"):
        assert torch.equal(aux_inf[k], aux0[k]), k

    # the cull fires and changes the image by less than the exit tolerance
    img1, _aux1, vis1 = _check_render(scene, pooled)
    assert int(vis1.sum()) < int(vis0.sum())
    assert (img1 - img0).abs().max().item() <= TOL_CULL

    # self-correction: the wall thins, the stale map over-culls, the walk no
    # longer saturates and gives back +inf; the next map re-admits all
    xyz, scales, rots, opac, colors = scene
    thin = (xyz, scales, rots, np.where(np.arange(len(opac)) < len(opac) - 200,
                                        np.float32(0.04), opac), colors)
    _img, aux2, _vis = _check_render(thin, pooled)
    assert not torch.isfinite(aux2["sat_depth"]).any()
    img_ref, _aux, vis_ref = _port_render(thin)
    img_next, _aux, vis_next = _check_render(thin, tsort.pool_sat_depth(aux2["sat_depth"], grid))
    assert torch.equal(img_next, img_ref) and torch.equal(vis_next, vis_ref)


def _dataset(make_cameras, scene):
    rng = np.random.default_rng(5)
    xyz = scene[0]
    poses = []
    for i in range(N_CAMS):
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = 0.1 * (i - 1.5)
        pose[1, 3] = 0.05 * (i % 2)
        poses.append(pose)
    f = W / (2 * np.tan(np.radians(60.0) / 2))
    cams = make_cameras(poses=np.stack(poses),
                        intrinsics=np.array([[f, f, W / 2, H / 2]] * N_CAMS, np.float32),
                        camera_models=np.zeros((N_CAMS,), np.int32),
                        distortion_parameters=np.zeros((N_CAMS, 6), np.float32),
                        image_sizes=np.array([[W, H]] * N_CAMS, np.int32))
    images = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(N_CAMS)]
    return dict(cameras=cams, images=images, masks=None, points3D_xyz=xyz,
                points3D_rgb=(np.clip(scene[4], 0, 1) * 255).astype(np.uint8),
                image_paths=[f"{i:03d}.png" for i in range(N_CAMS)], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={},
                images_points3D_indices=None)


def _caches(model, jax_side):
    return {k: np.asarray(v) if jax_side else v.numpy() for k, v in model._sat_caches.items()}


def _check_training(monkeypatch, rng):
    monkeypatch.setattr(jknn_native, "available", lambda: False)
    monkeypatch.setattr(twg, "mean_knn_dist2",
                        lambda t: torch.as_tensor(np.asarray(jknn(jnp.asarray(t.numpy())))))
    scene = _occluded_scene(rng)
    jm = jwg.WildGaussians(train_dataset=_dataset(jnew_cameras, scene),
                           config_overrides=dict(OVERRIDES))
    tm = WildGaussians(train_dataset=_dataset(new_cameras, scene),
                       config_overrides=dict(OVERRIDES), device="cpu")
    assert tm._use_satcull() and jm._use_satcull()
    # opaque, wide walls from the first step, so that tiles saturate
    n = scene[0].shape[0]
    logit = float(np.log(0.99 / 0.01))
    jm.params["opacities"] = jm.params["opacities"].at[:n].set(logit)
    jm.params["scales"] = jm.params["scales"].at[:n].set(float(np.log(0.5)))
    culled = []
    for step in range(STEPS):
        iteration = step + 1
        state = train_state_from_numpy(jm._state_dict(), tm.config)
        (tm.params, tm.mlp, tm.aux), tm.adam = state.model, state.adam
        for t in tm._trainable().values():
            t.requires_grad_(True)
        cam = step % N_CAMS
        before = {k: v[cam].copy() for k, v in _caches(tm, False).items()}
        jmetrics = jm.train_iteration(step, camera_id=cam)
        tmetrics = tm.train_iteration(step, camera_id=cam)
        np.testing.assert_allclose(tmetrics["loss"], jmetrics["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"iteration {iteration}")
        jc, tc = _caches(jm, True), _caches(tm, False)
        assert sorted(jc) == sorted(tc), iteration
        for k, v in jc.items():
            np.testing.assert_array_equal(tc[k], v, err_msg=f"iteration {iteration} {k}")
        if iteration in (6, 9):
            assert tc == {}, f"iteration {iteration} clears the maps"
        if any(np.isfinite(v).any() for v in before.values()):
            culled.append(iteration)
    assert culled == [5, 6], culled


def test_satcull_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    _check_cull(rng)
    _check_training(monkeypatch, rng)
